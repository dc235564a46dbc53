"""Host microseconds a call of the engine's step in the eval loop: the
enqueue of its kernels, with no synchronise (`bbx_torch.cli.evaluate`
calls `engine.step.step` by this name)."""
HOOKS = [("host", "bbx_torch.cli.evaluate:step")]


def read(run):
    spans = run.spans.get(HOOKS[0][1])
    if not spans:
        return None
    return sum(spans) / len(spans) * 1e6
