"""`faba` binary of the port: BAM feature extraction CLI (the JAX
package's `cli/faba_cli.py` tree, every subcommand and flag). `index`,
`genes`, `gem`, `gem-encoder` and `dyn-assoc` run; `gem`, `gem-encoder`
and `dyn-assoc` take `--device` (default `cuda`). The other subcommands
raise `NotImplementedError` (ROADMAP item 10c), as does `--data-parallel`
(item 11)."""

from __future__ import annotations

import argparse

from .faba_cmds import HANDLERS, PARSER_MODULES, plot_cmds
from .faba_cmds._common import not_ported


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="faba", description="BAM feature extraction")
    sub = ap.add_subparsers(dest="cmd", required=True)
    for mod in PARSER_MODULES:
        mod.add_parsers(sub)

    p = sub.add_parser("docs", help="print embedded method write-ups")
    p.add_argument("topic", nargs="?", default=None,
                   help="omit to list available topics")

    plot_cmds.add_parsers(sub)
    return ap


def run_faba(argv):
    args = build_parser().parse_args(argv)
    if args.cmd == "docs":
        not_ported("docs")
    return HANDLERS[args.cmd](args)
