"""Engine layer (the family's fitness, `search/backends.py`,
`families/printed_mlp.py`: each call counts the rows it scores in
`nsga2.evaluations`; a captured chunk adds its rows at each replay), tree
search: the rows counted over the traced stretch, over the generations
traced times the population. 1.0 where every generation scores each
child once; below it, rows scored once for several children; above it,
rows scored twice. A run that scores fewer children than it keeps fails
its check (`follow_gap`)."""
from perfbench import spans


def read(record):
    return spans.evals_share(record)
