"""Milliseconds a rollout step: a span, synchronised at both ends, around
each `bbx_torch.agent.ppo.rollout` call of the window, over the
configuration's rollout steps."""
HOOKS = [("span", "bbx_torch.agent.ppo:rollout")]


def read(run):
    spans = run.spans.get(HOOKS[0][1])
    if not spans:
        return None
    return sum(spans) / len(spans) / run.config["training"]["rollout_steps"] * 1e3
