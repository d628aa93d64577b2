"""`faba` binary of the port: BAM feature extraction CLI (the JAX
package's `cli/faba_cli.py` tree, every subcommand and flag). Every
subcommand runs; `gem`, `gem-encoder`, `lineage`, `dyn-assoc`, `annotate`
and `plot` take `--device` (default `cuda`), the others run on the host.
`gem` and `gem-encoder --data-parallel` run one rank a GPU
(`cli/faba_cmds/gem_cmds.py`)."""

from __future__ import annotations

import argparse

from .faba_cmds import HANDLERS, PARSER_MODULES, plot_cmds


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
        from ..faba import docs as faba_docs

        if args.topic is None:
            for line in faba_docs.index_lines():
                print(line)
        else:
            print(faba_docs.text(args.topic))
        return
    return HANDLERS[args.cmd](args)
