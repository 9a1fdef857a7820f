"""The program's side of each configuration kind, found by the
configuration's ``kind``: ``kinds/<kind>.py`` (:func:`module`) gives

- ``build(cfg, leaves, problem, device)``: a ``Flow`` of the configuration,
  built through the program's public constructors, holding ``leaves`` (name
  → tensor, the names of the kind's ``reference`` ``param_layout``);
- ``leaves(cfg, flow)``: name → the flow's parameter of that name;
- ``KERNELS``: generator name → the program's CUDA libraries that
  generator's calls load;
- ``Work(cfg)``: the operations and bytes of each entry point, from the
  shapes alone (see ``work.py``).

Its plain reference is ``reference/<kind>.py``. A new kind is these two
files; no other file of the harness changes.
"""

from __future__ import annotations

import importlib

__all__ = ["module"]


def module(cfg):
    """The kind module of ``cfg["kind"]``."""
    return importlib.import_module(f"{__name__}.{cfg['kind']}")
