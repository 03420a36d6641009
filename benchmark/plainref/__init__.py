"""The benchmark's plain reference: the configurations' scenes rendered in
plain PyTorch, to hold what the program's timed path produced against.

It imports torch and numpy only, never the program: its scene arrays, its
acceleration structure and its integrator are its own.  The shading, light,
sampling and random-number code are frozen copies of the port's plain
PyTorch at commit d1155b91 (the files named in each module); the
acceleration structure is not copied (``accel.py``), so a hit found here
owes nothing to the program's BVH.
"""
