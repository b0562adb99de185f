"""Flags every example main shares beyond its own."""

from __future__ import annotations

import argparse


def add_viewer(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--viewer", nargs="?", const=8080, type=int,
                    default=None, metavar="PORT",
                    help="serve the live map/frame viewer over HTTP (the "
                         "reference mains' bUseViewer; default port 8080)")


def add_device(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--device", default=None,
                    help="torch device to run on (default: the current "
                         "CUDA device; `cpu` to run on the CPU)")


def system_kwargs(args, device) -> dict:
    """System's viewer and device keywords from the parsed flags."""
    return dict(use_viewer=args.viewer is not None,
                viewer_port=args.viewer or 0, device=device)
