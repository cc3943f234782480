"""The benchmark's plain reference of MonoRUn: a frozen copy of the
forward, loss and update arithmetic of the PyTorch package under test,
with the RoIAlign always in its plain gather form and no kernel, no
cache and no process group. The benchmark runs it in float32 with TF32
off. It imports nothing of the package under test."""
