"""The port's ``pipeline/sample`` span (one sampled batch, copied to the
card), averaged over the window's batches."""


def read(rec):
    return 1e3 * sum(rec.sample_s) / len(rec.sample_s) if rec.sample_s else None
