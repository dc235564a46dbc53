"""Device milliseconds a minibatch of the update's optimizer step (the
gradient clip, the learning rate and Adam's step): CUDA events at the ends
of the program's `ppo.update.optimizer` span, averaged over the window's
minibatches (`perfbench/program_trace.py`)."""
from perfbench import program_trace

HOOKS = []


def read(run):
    return program_trace.device_ms(run, "ppo.update.optimizer")
