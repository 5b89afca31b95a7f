"""The benchmark's inputs, made from the seed.

Each module here is found by its name (``Registry.data``), as a
configuration's ``generator`` or ``batch`` entry names it:

* a generator exposes ``generate(*, seed, **params)`` and returns a
  time-sorted graph ``(u, v, t, n_nodes)``;
* a batch builder exposes ``build(graph, *, seed, **params)`` and returns
  a zone batch ``(u, v, t, valid, signs)``.

The modules are frozen copies of the program's own generators and
planners, so that a later change to the program cannot change the
benchmark's inputs; each names its original and what changed.
"""
