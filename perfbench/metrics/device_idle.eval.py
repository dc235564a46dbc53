"""`device_idle.train`, read over one eval job in the eval cell, where it
moves `eval_episodes_per_s`."""
from perfbench import harness

_train = harness.reader("device_idle.train")
HOOKS, read = _train.HOOKS, _train.read
