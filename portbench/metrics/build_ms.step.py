"""build_ms.step: the median of three replays of the step's tree build
(engine.build_tree, the step's configuration) on the window's last
state, each timed by CUDA events."""

import statistics

import torch


def read(run):
    state = getattr(run.entry, "state", None)
    if state is None or not state.pos.is_cuda:
        return None
    from rakau_tpu_torch import engine
    box = run.entry.config["box_size"]
    ms = []
    for _ in range(3):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        engine.build_tree(state.pos, state.mass, run.entry.cfg, box)
        b.record()
        b.synchronize()
        ms.append(a.elapsed_time(b))
    run.say(build_ms=ms)
    return statistics.median(ms)
