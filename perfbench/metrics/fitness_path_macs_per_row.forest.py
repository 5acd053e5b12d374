"""Kernels layer (`kernels/fitness.py`, `csrc/fitness.cu`), forest search:
the int8 multiply-adds the fitness kernel's path product runs a
(chromosome, sample) row, counted by the program: the counter
``fitness.path_macs`` (each launch adds P * B * 32 * sum of its leaf
tiles' comparator spans; a captured chunk adds its launches' at each
replay) over ``nsga2.evaluations`` x B. The plain count over the padded
path; a leaf order or tile that cuts the work off the trees' diagonal
blocks lowers it. None where the program keeps no such counter."""
from perfbench import spans


def read(record):
    macs = spans.counted(record, "search", "fitness.path_macs")
    rows = spans.counted(record, "search", "nsga2.evaluations")
    if not macs or not rows:
        return None
    return macs / (rows * record["shape"]["rows"])
