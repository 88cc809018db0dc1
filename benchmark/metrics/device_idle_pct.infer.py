"""Share of the traced slice of one large frame at a time in which the card
ran nothing: 100 × (1 − the union of its kernel and copy intervals ÷ the
slice's time), from `torch.profiler`'s device activity."""
from benchmark.readers import idle_pct


def read(run):
    return idle_pct(run.trace)
