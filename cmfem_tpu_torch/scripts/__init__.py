"""The study scripts of the repo (the JAX package's ``scripts/``), ported.

Each module runs as ``python -m cmfem_tpu_torch.scripts.<name>``, on the
CUDA device unless ``--cpu`` is given or CMFEM_FORCE_CPU=1 is set (none is
an error, as for the drivers), and writes only under its ``--out-dir``
(default: a new directory under the system's temporary directory):

  blocksolve_refinement  the ablation Newton systems' GMRES under strip
                         refinement, line MG against the point blocks
  fullrun                one ablation case over the full horizon of its
                         (synthetic) deck, with an artifact and ``sane``
  oracle_compare         the drift of one fullrun output against another
                         (the card against the CPU, both float64)
  accuracy_table         the analytic drivers' errors in float64 (CPU) and
                         float32 (card), and the float32 fields' deviation
  compensated_dots       float32 CG with and without a Neumaier dot against
                         a float64 oracle
  comms_model            the distributed paths' collective bytes per apply
                         and per CG iteration, counted on gloo ranks

``common`` holds what they share: the device and output directory, the
repo's synthetic inputs (``tests/fixtures/``) that stand in for the
reference decks, and the meshes they write.

``scripts/apply_experiments.py`` is not ported: its four variants (slab,
2-element slab, MXU z, VPU z) are TPU Pallas kernel variants with no
counterpart on the card.  The port's sweep of the operator paths is
``profiling.py``'s operator section together with chip_smoke phases 4-8.
"""
