"""Gated compiler debug logging (a copy of ``stgraph_tpu/compiler/debugging.py``).

Role-parity with the reference's ``stgraph/compiler/debugging/``
(``print_log`` via rich Console, globally gated by
``is_print_verbose_log``). Enable with ``set_verbose(True)`` or env
``STGRAPH_TPU_TORCH_VERBOSE=1``; ``dump_program`` pretty-prints a traced IR
Program (the visualizer counterpart of the reference's SVG dumps,
``passes/visualize.py``, without the graphviz dependency).
"""

from __future__ import annotations

import os
import sys

__all__ = ["is_verbose", "set_verbose", "print_log", "dump_program"]

_verbose = os.environ.get("STGRAPH_TPU_TORCH_VERBOSE", "") not in ("", "0", "false")


def is_verbose() -> bool:
    return _verbose


def set_verbose(value: bool) -> None:
    global _verbose
    _verbose = bool(value)


def print_log(*args, **kwargs) -> None:
    """Log to stderr when verbose logging is enabled."""
    if _verbose:
        print("[stgraph_tpu_torch]", *args, file=sys.stderr, **kwargs)


def dump_program(program, output=None, title: str = "Program") -> str:
    """Render an IR ``Program`` as an indented statement listing.

    Returns the text; also prints it to ``output`` (default stderr) when
    verbose logging is on.
    """
    lines = [f"== {title} =="]
    for stmt in program.stmts:
        args = ", ".join(
            f"{a.id}:{a.val_type.name}{list(a.shape)}" for a in stmt.args
        )
        kw = f" {stmt.kwargs}" if stmt.kwargs else ""
        lines.append(
            f"  {stmt.ret.id}:{stmt.ret.val_type.name}{list(stmt.ret.shape)}"
            f" = {stmt.op}({args}){kw}"
        )
    text = "\n".join(lines)
    if _verbose:
        print(text, file=output or sys.stderr)
    return text
