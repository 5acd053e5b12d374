"""Bespoke approximate decision trees: training, layout, encoding, area,
NSGA-II, netlist and RTL (the single-tree slice of `repro.core`)."""
