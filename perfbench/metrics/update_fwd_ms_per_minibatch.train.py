"""Device milliseconds a minibatch of the update's forward (the
minibatch's row gather, the network's forward and the loss): CUDA events
at the ends of the program's `ppo.update.forward` span, averaged over the
window's minibatches (`perfbench/program_trace.py`)."""
from perfbench import program_trace

HOOKS = []


def read(run):
    return program_trace.device_ms(run, "ppo.update.forward")
