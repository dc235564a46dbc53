"""GUI launcher: counterpart of `run_gui.py`.

    python -m bbx_torch.gui [--device cpu]

Checks that tkinter is present, then starts the Tkinter app (menu / human
play / training / watch pages) on the CUDA card, or on the CPU when asked.
"""
from __future__ import annotations

import argparse
import sys

from ..device import resolve_device


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="The Block Blast GUI on bbx_torch")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the game, the agent and the trainer "
                         "(default cuda; 'cpu' to run there)")
    args = ap.parse_args(argv)
    try:
        import tkinter  # noqa: F401
    except ImportError:
        print("error: tkinter is not available in this Python build.\n"
              "On Debian/Ubuntu: sudo apt install python3-tk", file=sys.stderr)
        return 1
    device = resolve_device(args.device)

    from .app import main as gui_main
    return gui_main(device)


if __name__ == "__main__":
    raise SystemExit(main())
