"""The benchmark's plain reference: a frozen copy of the port's plain
engine (config, constants, prng, state, engine/*, env), its RAM frame
(obs/ram.py), its screen frame (obs/frame.py, with the helpers of
obs/screen.py) and its reward and done rules, with the imports rewritten
to this package, plus the kernel-layout decoder (layout.py) that reads
the port's resident planes, and the gym's action and cutoff rules
(gym.py).

It imports torch, numpy and the standard library only: neither JAX, the
JAX package, nor anything of the port. Later changes to the port do not
reach it, so it stays the yardstick the benchmark's check holds every
cell's outputs against (benchmark/check.py).
"""
