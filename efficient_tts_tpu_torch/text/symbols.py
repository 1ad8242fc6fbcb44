"""Symbol inventory for character-level text input.

Behaviorally matches the reference inventory
(the reference's `nntts/text/symbols.py`, keithito/tacotron lineage;
this is a copy of `efficient_tts_tpu/text/symbols.py`):
148 symbols = pad `_` + special `-` + punctuation + ASCII letters +
`@`-prefixed ARPAbet phones. Symbol ids must match the reference exactly
for checkpoint/text-id parity.
"""

from efficient_tts_tpu_torch.text.arpabet import VALID_ARPABET

PAD = "_"
_punctuation = "!'(),.:;? "
_special = "-"
_letters = "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz"

# "@" prefix keeps ARPAbet distinct from uppercase letters.
_arpabet = ["@" + s for s in VALID_ARPABET]

symbols = [PAD] + list(_special) + list(_punctuation) + list(_letters) + _arpabet
