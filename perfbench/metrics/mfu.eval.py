"""The whole eval step's share of the card's dense peak, in %: the
network's forward on every lane at every step of the traced window
(finished lanes included; the steps counted at the engine's step) over
the window's wall time and the peak of the compute dtype."""
from perfbench import flops

HOOKS = [("host", "bbx_torch.cli.evaluate:step")]


def read(run):
    steps = len(run.spans.get(HOOKS[0][1], ()))
    if not run.cuda or not steps:
        return None
    import torch

    net = run.config["network"]
    peak = flops.PEAK_FLOPS.get(torch.cuda.get_device_name(0), {}).get(
        net.get("compute_dtype", "bfloat16"))
    if not peak:
        return None
    work = steps * flops.forward_flops(net, run.traffic["episodes"])
    return 100.0 * work / run.window_s / peak
