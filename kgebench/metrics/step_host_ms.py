"""The host's time inside the step call, averaged over the window: what it
takes to enqueue a step."""


def read(rec):
    spans = [r - c for c, r in zip(rec.call_s, rec.return_s)]
    return 1e3 * sum(spans) / len(spans) if spans else None
