"""Device milliseconds a minibatch of the update's backward
(`loss.backward()`: K8b, K8w and the reduction on the card): CUDA events
at the ends of the program's `ppo.update.backward` span, averaged over the
window's minibatches (`perfbench/program_trace.py`)."""
from perfbench import program_trace

HOOKS = []


def read(run):
    return program_trace.device_ms(run, "ppo.update.backward")
