"""Share of the traced slice of training steps in which the card ran
nothing: 100 × (1 − the union of its kernel and copy intervals ÷ the
slice's time), from `torch.profiler`'s device activity."""
from benchmark.readers import idle_pct


def read(run):
    return idle_pct(run.trace)
