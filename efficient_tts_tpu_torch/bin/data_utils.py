"""Filelist split / combine / subset (counterpart of `efficient_tts_tpu/bin/data_utils.py`).

The recipe-tooling analog of the reference's Kaldi-style data-dir
utilities (`utils/split_data.sh`, `utils/combine_data.sh`,
`utils/make_subset_data.sh`), on the `path|text` filelists that
`data/dataset.py` reads:

    split    src.txt first.txt second.txt [--num_first N] [--num_second M]
             [--shuffle] [--seed 1234]
             Two-way split. Counts auto-balance like split_data.sh: with
             neither given, halves; with one given, the rest goes to the
             other side. --shuffle randomizes order first (fixed seed).

    combine  dst.txt src1.txt src2.txt [...]
             Concatenate filelists, de-duplicated by wav path (first
             occurrence wins, like Kaldi's sort -u on utt ids) and
             sorted by path for determinism.

    subset   src.txt num_split outdir/
             Write outdir/split.{1..N}.txt contiguous shards (Kaldi
             split_scp.pl semantics: sizes differ by at most one) for
             parallel offline feature extraction.

Host work on text files; it touches no device.
"""

from __future__ import annotations

import argparse
import os
import random
import sys


def _read_lines(path: str) -> list:
    with open(path, encoding="utf-8") as f:
        return [ln.rstrip("\n") for ln in f if ln.strip()]


def _write_lines(path: str, lines) -> None:
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        for ln in lines:
            f.write(ln + "\n")


def cmd_split(args) -> int:
    lines = _read_lines(args.src)
    n = len(lines)
    num_first, num_second = args.num_first, args.num_second
    if num_first == 0 and num_second == 0:
        num_first = n // 2
        num_second = n - num_first
    elif num_first > 0 and num_second == 0:
        if n <= num_first:
            print(f"ERROR: --num_first {num_first} >= #utts {n}", file=sys.stderr)
            return 1
        num_second = n - num_first
    elif num_first == 0 and num_second > 0:
        if n <= num_second:
            print(f"ERROR: --num_second {num_second} >= #utts {n}", file=sys.stderr)
            return 1
        num_first = n - num_second
    if num_first + num_second != n:
        print(
            f"ERROR: num_first + num_second != #utts ({num_first}+{num_second} != {n})",
            file=sys.stderr,
        )
        return 1
    if args.shuffle:
        rng = random.Random(args.seed)
        rng.shuffle(lines)
    _write_lines(args.first, lines[:num_first])
    _write_lines(args.second, lines[num_first:])
    print(f"split {n} -> {num_first} + {num_second}")
    return 0


def cmd_combine(args) -> int:
    seen = {}
    for src in args.srcs:
        for ln in _read_lines(src):
            key = ln.split("|", 1)[0]
            if key not in seen:
                seen[key] = ln
    lines = [seen[k] for k in sorted(seen)]
    _write_lines(args.dst, lines)
    print(f"combined {len(args.srcs)} filelists -> {len(lines)} utts")
    return 0


def cmd_subset(args) -> int:
    lines = _read_lines(args.src)
    n, k = len(lines), args.num_split
    if k <= 0 or k > n:
        print(f"ERROR: bad num_split {k} for {n} utts", file=sys.stderr)
        return 1
    os.makedirs(args.outdir, exist_ok=True)
    base, rem = divmod(n, k)
    start = 0
    for i in range(k):
        size = base + (1 if i < rem else 0)
        _write_lines(
            os.path.join(args.outdir, f"split.{i + 1}.txt"),
            lines[start : start + size],
        )
        start += size
    print(f"wrote {k} shards of ~{base} utts to {args.outdir}")
    return 0


def get_parser():
    p = argparse.ArgumentParser(description="Filelist split/combine/subset")
    sub = p.add_subparsers(dest="cmd", required=True)

    sp = sub.add_parser("split", help="two-way split")
    sp.add_argument("src")
    sp.add_argument("first")
    sp.add_argument("second")
    sp.add_argument("--num_first", type=int, default=0)
    sp.add_argument("--num_second", type=int, default=0)
    sp.add_argument("--shuffle", action="store_true")
    sp.add_argument("--seed", type=int, default=1234)
    sp.set_defaults(fn=cmd_split)

    cp = sub.add_parser("combine", help="concatenate filelists")
    cp.add_argument("dst")
    cp.add_argument("srcs", nargs="+")
    cp.set_defaults(fn=cmd_combine)

    up = sub.add_parser("subset", help="contiguous shards for parallel jobs")
    up.add_argument("src")
    up.add_argument("num_split", type=int)
    up.add_argument("outdir")
    up.set_defaults(fn=cmd_subset)
    return p


def main(argv=None) -> int:
    args = get_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
