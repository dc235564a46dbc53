"""The evaluator backward's share of its roofline, in %: the least time
its required work takes at a minibatch's shapes
(`perfbench.flops.evaluator_backward`: no recompute, each input byte read
once, each output byte written once), over the device time between CUDA
events at the start and end of `EvaluatorFunction.backward`, summed over
the window's calls."""
from perfbench import flops

HOOKS = [("events", "bbx_torch.models.afterstate:EvaluatorFunction.backward")]


def read(run):
    ms = run.device_ms.get(HOOKS[0][1])
    if not ms:
        return None
    import torch

    net = run.config["network"]
    dtype = net.get("compute_dtype", "bfloat16")
    ops, nbytes = flops.evaluator_backward(run.config["training"]["batch_size"],
                                           flops.evaluator_widths(net),
                                           2 if dtype == "bfloat16" else 4)
    bound = flops.bound_s(ops, nbytes, torch.cuda.get_device_name(0), dtype)
    return 100.0 * bound * len(ms) / (sum(ms) * 1e-3)
