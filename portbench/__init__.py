"""The benchmark of rustlight_tpu_torch on an NVIDIA H100.

One command runs one cell once (`python3 -m portbench.run`, see run.py).
Everything that belongs to one configuration, traffic mix or per-layer
metric sits in a file of its own, found by the name BENCHMARK.json gives:

  configs/<config>.json   the scene: materials, camera, shapes; the
                          integrators' settings; source, assumed, reduced
  shapes/<kind>.py        a kind of shape those files name
  materials/<kind>.py     a kind of material they name, for the renderer
  integrators/<name>.py   an integrator a mix names, for the renderer
  traffic/<mix>.json      a traffic mix, read by the one loop of window.py
  metrics/<metric>.py     the reader of one per-layer metric (trace.py)
  limits/<workload>.json  the limits of the numbers `correct` compares

The plain reference (reference/, with reference/materials/<kind>.py and
reference/integrators/<name>.py beside the renderer's) imports nothing of
the renderer; port.py, trace.py, materials/ and integrators/ are the only
code that does.
"""
