"""The port's text front end (`efficient_tts_tpu_torch/text/`) against the JAX
package's, exactly: the ids index the embedding, so any difference is a
different model input."""

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from efficient_tts_tpu import text as jtext
from efficient_tts_tpu.text import cleaners as jcleaners
from efficient_tts_tpu.text import mandarin as jmandarin
from efficient_tts_tpu.text import numbers_en as jnumbers
from efficient_tts_tpu.text import symbols as jsymbols  # the package re-exports the list
from efficient_tts_tpu_torch import text
from efficient_tts_tpu_torch.text import cleaners, mandarin, numbers_en, symbols  # the list, as above

STRINGS = [
    "Hello there.",
    "The quick brown fox jumps over the dog.",
    "I have 3 apples and 1,024 oranges.",
    "He finished 1st, she 2nd, they 23rd and we 101st.",
    "It costs $3.50, or $1 or $0.01 or $12,000.",
    "Pi is about 3.14159 and e is 2.718.",
    "In 1999, 2000, 2007 and 1066 things happened; 1900 too.",
    "Mr. and Mrs. Smith met Dr. Jones, Gen. Lee and Capt. Hook on St. James St.",
    "Lt. Col. Sgt. Maj. Esq. Ltd. Co. Jr. Ft. Rev. Hon.",
    "Say {HH AH0 L OW1} to the {W ER1 L D}.",
    "{HH AW1 S} alone",
    "Mixed {AH0} and text {B IY1} end",
    "Café naïve résumé coöperate façade",
    "Straße, Ærø, Øresund, œuvre",
    "日本語のテキスト and English",
    "Multiple     spaces\tand\ttabs\nand newlines",
    "Punctuation!!! What?! (Really) -- yes; no: maybe...",
    "'Quoted' \"double\" `back` ~tilde~ _under_",
    "",
    "   ",
    "12345678901234567890",
    "0 00 007 0.5 .5 5.",
    "1,000,000 and 999,999,999",
    "£100 and €200 and ¥300",
    "ALL CAPS SENTENCE WITH NUMBERS 42",
    "a-b-c hyphen-ated words",
    "Numbers in words: 11 12 13 19 20 21 99 100 101 110 999",
    "The 20th century, the 21st, the 1000th.",
    "Emoji 🙂 and symbols © ® ™",
    "{INVALID PHONES} and {AA1}",
]


def test_symbol_inventory_is_the_jax_one():
    assert symbols == jsymbols and len(symbols) == 148


@pytest.mark.parametrize("s", STRINGS)
def test_text_to_sequence_equals_jax(s):
    ids = text.text_to_sequence(s)
    assert ids == jtext.text_to_sequence(s)
    assert text.sequence_to_text(ids) == jtext.sequence_to_text(ids)
    for name in ("basic_cleaners", "transliteration_cleaners", "english_cleaners"):
        assert text.text_to_sequence(s, (name,)) == jtext.text_to_sequence(s, (name,))
        assert getattr(cleaners, name)(s) == getattr(jcleaners, name)(s)
    assert numbers_en.normalize_numbers(s) == jnumbers.normalize_numbers(s)


def test_unknown_cleaner_raises_as_jax():
    for mod in (text, jtext):
        with pytest.raises(ValueError, match="Unknown cleaner"):
            mod.text_to_sequence("x", ("no_such_cleaner",))


@settings(max_examples=50, deadline=None, database=None)
@given(st.text(max_size=80))
def test_text_to_sequence_equals_jax_on_any_text(s):
    ids = text.text_to_sequence(s)
    assert ids == jtext.text_to_sequence(s)
    assert text.sequence_to_text(ids) == jtext.sequence_to_text(ids)


def test_phones_to_sequence_equals_jax(tmp_path):
    path = tmp_path / "phones.txt"
    path.write_text("sil\nHH\nAH0\n\nL\n  OW1  \nsp\n")
    vocab = text.load_phone_vocab(str(path))
    assert vocab == jtext.load_phone_vocab(str(path))
    assert vocab == {"sil": 0, "HH": 1, "AH0": 2, "L": 3, "OW1": 4, "sp": 5}
    for s in ("sil HH AH0 L OW1 sp", "  HH   OW1\tsp ", ""):
        assert text.phones_to_sequence(s, vocab) == jtext.phones_to_sequence(s, vocab)
    for mod in (text, jtext):
        with pytest.raises(KeyError):
            mod.phones_to_sequence("HH XX", vocab)


def test_mandarin_equals_jax():
    for s in ("ang3", "zh", "a1", "er5", "ng2"):
        assert mandarin.split_phone_tone(s) == jmandarin.split_phone_tone(s)
    for s in ("zhang", "an", "shi", "chi", "ci", "yu", "er"):
        assert mandarin.split_initial_final(s) == jmandarin.split_initial_final(s)
    for s in ("zh-ang3", "a1", "h-ao3"):
        assert mandarin.parse_pinyin_phn_tone_sep(s) == jmandarin.parse_pinyin_phn_tone_sep(s)
    lines = ["word1 n x 0 #1 zh-ang3|d-e5", "word2 n x JH #3 h-ao3"]
    for py_type in ("PHN_TONE_SEP", "PHN_TONE"):
        assert mandarin.parse_sent(lines, py_type) == jmandarin.parse_sent(lines, py_type)
    out = mandarin.parse_sent(lines, "PHN_TONE_SEP")
    assert out[0] == "_HEAD" and out[-1] == "_TAIL" and "_SPS_SEG" in out
