"""A metrics table for the drivers' per-epoch rows.

A copy of ``stgraph_tpu/utils/data_table.py``: ``DataTable`` collects rows
and prints them with rich where rich is installed, else as the same plain
text (title, a ``" | "``-joined header and rows padded to each column's
widest entry).
"""

from __future__ import annotations

from typing import List, Sequence

__all__ = ["DataTable"]


class DataTable:
    """Collects rows and pretty-prints them (rich if available, else
    plain text)."""

    def __init__(self, title: str, column_names: Sequence[str]) -> None:
        self.title = title
        self.column_names = list(column_names)
        self.rows: List[List[str]] = []

    def add_row(self, row: Sequence) -> None:
        if len(row) != len(self.column_names):
            raise ValueError(f"row has {len(row)} entries, expected {len(self.column_names)}")
        self.rows.append([str(x) for x in row])

    def display(self) -> None:
        try:
            from rich.console import Console
            from rich.table import Table
        except ImportError:
            widths = [
                max(len(str(c)), *(len(r[i]) for r in self.rows)) if self.rows else len(c)
                for i, c in enumerate(self.column_names)
            ]
            print(self.title)
            print(" | ".join(c.ljust(w) for c, w in zip(self.column_names, widths)))
            for row in self.rows:
                print(" | ".join(v.ljust(w) for v, w in zip(row, widths)))
            return
        table = Table(title=self.title)
        for name in self.column_names:
            table.add_column(name)
        for row in self.rows:
            table.add_row(*row)
        Console().print(table)
