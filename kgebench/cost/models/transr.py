"""TransR's products a step: h M_r and t M_r a triplet, then each side's
pool of negatives projected once through each distinct M_r of its group (a
triplet's negatives share the projection with every triplet of its group
and relation)."""

READS = ("entity", "relation", "projection")


def products(b, k, d, rd, rel_groups):
    return 2 * (2 * b * d * rd) + 2 * 2 * rel_groups * k * d * rd
