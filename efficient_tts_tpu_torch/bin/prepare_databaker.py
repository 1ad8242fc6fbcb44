"""DataBaker (BZNSYP) corpus preparation: pronunciation labels -> phone filelists.

Counterpart of `efficient_tts_tpu/bin/prepare_databaker.py`, over the
port's Mandarin front end (`text/mandarin.py`). The BZNSYP distribution
ships `ProsodyLabeling/000001-010000.txt` with alternating hanzi+prosody /
pinyin lines. This tool writes `wav|phone-token` filelists (test, dev,
train) that `data/dataset.py:TextMelDataset` reads with `use_phnseq`, and
the phone inventory `phnset.txt`:

    python -m efficient_tts_tpu_torch.bin.prepare_databaker --db_root BZNSYP --outdir data/databaker

Host work on text files; it touches no device.
"""

from __future__ import annotations

import argparse
import logging
import os


def get_parser():
    p = argparse.ArgumentParser(description="Prepare DataBaker filelists")
    p.add_argument("--db_root", required=True, help="BZNSYP root (Wave/, ProsodyLabeling/)")
    p.add_argument("--outdir", required=True)
    p.add_argument("--dev", type=int, default=100)
    p.add_argument("--test", type=int, default=200)
    return p


def parse_label_file(path: str):
    """Yields (utt_id, pinyin_syllables) from the BZNSYP label format:
    line pairs of '<id>\\t<hanzi with #n marks>' then '\\t<pinyin ...>'."""
    with open(path, encoding="utf-8") as f:
        lines = [line.rstrip("\n") for line in f]
    for i in range(0, len(lines) - 1, 2):
        head = lines[i].strip()
        pinyin = lines[i + 1].strip()
        if not head or not pinyin:
            continue
        utt_id = head.split()[0].split("\t")[0]
        yield utt_id, pinyin.split()


def main(argv=None):
    args = get_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    from efficient_tts_tpu_torch.text.mandarin import split_initial_final

    label_file = os.path.join(args.db_root, "ProsodyLabeling", "000001-010000.txt")
    os.makedirs(args.outdir, exist_ok=True)

    entries = []
    phones_seen = set()
    for utt_id, syllables in parse_label_file(label_file):
        tokens = []
        for syl in syllables:
            head = syl.rstrip("0123456")
            tone = syl[len(head):] or "5"
            tokens.extend(split_initial_final(head))
            # the tone attaches to the final (phoneme-level sets attach per unit)
            if tokens:
                tokens[-1] = tokens[-1] + tone
        phones_seen.update(tokens)
        wav = os.path.join(args.db_root, "Wave", f"{utt_id}.wav")
        entries.append(f"{wav}|{' '.join(tokens)}")

    splits = {
        "test": entries[: args.test],
        "dev": entries[args.test: args.test + args.dev],
        "train": entries[args.test + args.dev:],
    }
    for name, chunk in splits.items():
        with open(os.path.join(args.outdir, f"{name}.txt"), "w", encoding="utf-8") as f:
            f.write("\n".join(chunk) + "\n")
        logging.info("%s: %d utterances", name, len(chunk))

    phnset = sorted(phones_seen)
    with open(os.path.join(args.outdir, "phnset.txt"), "w", encoding="utf-8") as f:
        f.write("\n".join(phnset) + "\n")
    logging.info("phone inventory: %d tokens -> phnset.txt", len(phnset))


if __name__ == "__main__":
    main()
