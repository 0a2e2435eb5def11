"""The plain reference the benchmark holds the renderer's films to: plain
PyTorch and NumPy, built from the configuration's own arrays, importing
nothing of the renderer under test (a test checks that)."""
