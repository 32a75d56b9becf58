"""
The plain reference of the imaging operations the benchmark checks, in
plain PyTorch: the explicit DFT dirty image at chosen pixels, the forward
model of a sparse image, and the Hogbom minor cycle. It imports nothing
of the program and takes nothing the program made, except where a minor
cycle has to follow the program's own state (``clean.py`` says which).
"""
