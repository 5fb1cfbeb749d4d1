"""ms_per_step.moving: ``ms_per_step``, by its reader, in team7.moving, where
it moves ``solve_card_ms_per_step``: that cell's wall time is paced by the
shared host and spreads too far for a bound (PERF.md)."""

from pathlib import Path

from ecbench.cellspec import load_reader

read = load_reader(Path(__file__).resolve().parents[1], "ms_per_step")
