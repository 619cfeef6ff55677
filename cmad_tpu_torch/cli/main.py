"""``python -m cmad_tpu_torch <command> deck.yaml``: the argparse
dispatcher.

Port of ``cmad_tpu/cli/main.py`` (parity: reference
``cmad/cli/main.py:21``). Each command goes straight to
``cli/common.run_command``, which dispatches on the deck's problem type
(the JAX package's one-function command modules are folded into it). The
commands run on the card unless the caller asks for the CPU: ``--device
cpu`` on the command line, or ``main(argv, device="cpu")`` from code.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

from cmad_tpu_torch import config
from cmad_tpu_torch.cli.common import run_command

_SUBCOMMANDS = {
    "primal": "Run a forward (primal) solve.",
    "objective": "Run a forward solve and accumulate the QoI J.",
    "gradient": "Compute the gradient of J.",
    "hessian": "Compute the Hessian of J.",
    "calibrate": "Optimize active parameters against the QoI via scipy.",
}


def main(argv: list[str] | None = None, device=None) -> int:
    """Run the command of ``argv``; ``device`` (a torch device or its
    name) overrides ``--device``, whose default is the card."""
    parser = argparse.ArgumentParser(prog="python -m cmad_tpu_torch")
    sub = parser.add_subparsers(dest="subcommand", required=True)
    for name, help_text in _SUBCOMMANDS.items():
        p = sub.add_parser(name, help=help_text)
        p.add_argument("deck", type=Path, help="Path to the YAML deck.")
        p.add_argument("--device", default=str(config.DEFAULT_DEVICE),
                       help="torch device to run on (default: the card)")

    args = parser.parse_args(argv)
    return run_command(args.subcommand, args.deck,
                       device=args.device if device is None else device)


def console_main() -> None:
    sys.exit(main())


if __name__ == "__main__":
    sys.exit(main())
