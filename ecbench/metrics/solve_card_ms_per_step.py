"""solve_card_ms_per_step (end to end, the card's clock): the card's
milliseconds a step in the step's linear solve, the part of a step that the
card and not the host paces.  :func:`install`, just before the window,
times every launch of the solve's device program (``SolveGraph.launch``:
the whole BiCGSTAB solve, its WHILE loop included, as one graph) by CUDA
timing events recorded on the current stream just before and just after
it; summed over the window and divided by its steps.  Read after the
window, whose last transient ends in a wait for its last step.  None off
the card.  (Events around ``Simulation.solve`` would also hold the card's
wait for the host's staging launches before the graph: 1.8-3.6% a set on a
slow host.)"""

import torch


def install(sim):
    """Time each solve graph launch from now on; returns the list its
    (start, end) events go into, None off the card."""
    if sim.device.type != "cuda":
        return None
    from eddy_currents_3d_tpu_torch.utils.graph import SolveGraph

    # the untimed launch, kept across installs so that timings never nest
    launch = SolveGraph.__dict__.get("untimed_launch", SolveGraph.launch)
    pairs = []

    def timed(graph):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        launch(graph)
        end.record()
        pairs.append((start, end))
    SolveGraph.untimed_launch, SolveGraph.launch = launch, timed
    return pairs


def read(ctx):
    pairs, w = ctx["installed"].get("solve_card_ms_per_step"), ctx["window"]
    if not pairs or not w["steps"]:
        return None
    return sum(s.elapsed_time(e) for s, e in pairs) / w["steps"]
