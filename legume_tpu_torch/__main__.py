"""`python -m legume_tpu_torch <binary> <subcommand> ...` entry point."""

from .cli.main import main

raise SystemExit(main())
