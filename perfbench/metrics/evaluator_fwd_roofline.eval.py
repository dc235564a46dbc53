"""The evaluator forward's share of its roofline, in %: the least time
its required work takes on the job's lanes
(`perfbench.flops.evaluator_forward`), over the device time between CUDA
events around each call of K8's launch (`_evaluator_scores_cuda`, which
`EvaluatorFunction.forward` calls on the card), summed over the window."""
from perfbench import flops

HOOKS = [("events", "bbx_torch.models.afterstate:_evaluator_scores_cuda")]


def read(run):
    ms = run.device_ms.get(HOOKS[0][1])
    if not ms:
        return None
    import torch

    net = run.config["network"]
    dtype = net.get("compute_dtype", "bfloat16")
    ops, nbytes = flops.evaluator_forward(run.traffic["episodes"], flops.evaluator_widths(net),
                                          2 if dtype == "bfloat16" else 4)
    bound = flops.bound_s(ops, nbytes, torch.cuda.get_device_name(0), dtype)
    return 100.0 * bound * len(ms) / (sum(ms) * 1e-3)
