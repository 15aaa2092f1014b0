"""The host's time from a step's return to the next step's call, averaged
over the window: the loop's wait for a batch and its hooks."""


def read(rec):
    gaps = [c - r for r, c in zip(rec.return_s, rec.call_s[1:])]
    return 1e3 * sum(gaps) / len(gaps) if gaps else None
