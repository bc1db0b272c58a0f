"""Hand-written CUDA kernels for the port's hot spots.

Each kernel ships as <name>/<name>.py (ctypes wrapper + launch counter),
<name>/ops.py (public op with layout + dispatch), <name>/ref.py (plain
torch version) and <name>/csrc/*.cu (the CUDA source, built by build.py).
A CUDA tensor launches the kernel; a CPU tensor takes the plain version.
"""
