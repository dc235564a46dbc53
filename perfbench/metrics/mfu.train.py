"""The whole training step's share of the card's dense peak, in %: the
FLOPs of the window's iterations (`perfbench.flops.train_iteration_flops`:
the rollout's forwards, the last value, the search's value forwards, the
minibatches' gradient steps, no recompute) over the traced window's wall
time and the peak of the configuration's compute dtype."""
from perfbench import flops

HOOKS = []


def read(run):
    if not run.cuda or not run.units:
        return None
    import torch

    net, t, p = run.config["network"], run.config["training"], run.config["ppo"]
    peak = flops.PEAK_FLOPS.get(torch.cuda.get_device_name(0), {}).get(
        net.get("compute_dtype", "bfloat16"))
    if not peak:
        return None
    work = flops.train_iteration_flops(net, t["num_envs"], t["rollout_steps"], p["num_epochs"],
                                       t["batch_size"], run.search_width)
    return 100.0 * work * run.units / run.window_s / peak
