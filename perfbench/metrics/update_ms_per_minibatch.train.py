"""Milliseconds a minibatch of the update: a span, synchronised at both
ends, around each `bbx_torch.agent.ppo.update` call of the window, over
its epochs times minibatches."""
HOOKS = [("span", "bbx_torch.agent.ppo:update")]


def read(run):
    spans = run.spans.get(HOOKS[0][1])
    if not spans:
        return None
    t, p = run.config["training"], run.config["ppo"]
    minibatches = p["num_epochs"] * (t["num_envs"] * t["rollout_steps"] // t["batch_size"])
    return sum(spans) / len(spans) / minibatches * 1e3
