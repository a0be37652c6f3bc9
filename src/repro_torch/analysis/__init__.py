"""Static analysis of the integer serving datapath.

Submodules (import them directly; this package namespace stays empty so
``boundary`` can be imported from kernel and model modules without cycles):

* ``boundary``    — the named scopes the auditor recognizes: kernel
  boundaries, exact integer products and CUDA kernel launches.
* ``graph_audit`` — records a hot step's aten ops and enforces the
  integer-datapath rules over them.
* ``kernel_lint`` — checks over the CUDA kernels: index bounds, shared
  memory, argument order, shared bodies.
* ``cost``        — bytes by dtype and op counts of a recorded step.
* ``report``      — frozen versioned ANALYSIS.json schema + baseline diff.
* ``fixtures``    — intentionally-broken steps the analyzers must flag.
* ``analyze``     — CLI: ``python -m repro_torch.analysis.analyze``.
"""
