"""device_idle_pct.lim: ``device_idle_pct``, by its reader, in lim.recip,
where it moves ``solve_card_ms_per_step``: that cell's wall time is paced by
the host's relocation and scatter of its 12 windings (PERF.md)."""

from pathlib import Path

from ecbench.cellspec import load_reader

read = load_reader(Path(__file__).resolve().parents[1], "device_idle_pct")
