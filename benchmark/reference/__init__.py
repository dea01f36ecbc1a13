"""The benchmark's plain reference: plain PyTorch and NumPy that decide
whether a run's outputs are correct. It imports nothing of the program
(``ppr_diffphys_torch``), of ``jax`` or of ``ppr_diffphys_tpu``.

``ops/``, ``sim/`` (builder, URDF import, meshes, the plain integrator,
FK), ``data/``, ``utils/config.py`` and ``models/`` (the time-MLPs and
camera MLPs, the losses, the lab4d field stand-ins, the imitation model and
the lab4d interface) are frozen copies of the port's plain modules. Their
edits: the imports of ``plain.py``, which stands in for the kernels (the
plain window and the plain interval, the latter replayed as CUDA graphs
on the card) and for the multi-GPU layer (one process); and the constant
tensors of the integrator, FK and quaternion helpers made once per device
instead of copied from the host at every call (the same values; a
host-to-device copy at every substep waits for the stream). The program's
later changes do not reach them.
"""
