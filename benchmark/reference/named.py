"""Modules found by name: each one file of a package of its own (a model
family's reference, its FLOP count, a kernel's bound), which a later change
adds as a new file without editing any file that is there."""

from __future__ import annotations

import importlib
import re
from pathlib import Path
from types import ModuleType

NAME = re.compile(r"[A-Za-z_][A-Za-z0-9_]*")


def load_named(package: str, name: str, what: str) -> ModuleType:
    """The module `<package>.<name>`, from the file `<name>.py` beside the
    package's `__init__.py`; a name with no such file raises, naming the
    path it looked for."""
    path = Path(importlib.import_module(package).__file__).parent / f"{name}.py"
    if not NAME.fullmatch(name) or name == "__init__" or not path.is_file():
        raise ValueError(f"no {what} for {name!r}: expected the file {path}")
    return importlib.import_module(f"{package}.{name}")
