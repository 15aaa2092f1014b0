"""RESCAL's products a step: M_r^T h and M_r t a triplet, then o . n over
the group's pool of negatives on each side."""

READS = ("entity", "projection")


def products(b, k, d, rd, rel_groups):
    """Forward FLOPs of the products; ``rel_groups`` (distinct relations,
    summed over the negative groups) is not needed here."""
    return 2 * (2 * b * d * rd) + 2 * b * rd + 2 * b * k * rd + 2 * b * k * d
