"""The command line every example shares: ``--device`` (default: the CUDA
device)."""

import argparse


def run(main, doc, **extra):
    """Parse ``--device`` plus ``extra`` options (name → (type, default))
    and call ``main`` with them."""
    ap = argparse.ArgumentParser(description=doc)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    for name, (kind, default) in extra.items():
        ap.add_argument(f"--{name}", type=kind, default=default)
    args = vars(ap.parse_args())
    main(**args)
