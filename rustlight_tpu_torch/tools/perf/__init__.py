"""The walk tier's laboratory: roofline, tree_lab and trace_122k, the port's
counterparts of the JAX package's tools/perf/ scripts of those names."""
