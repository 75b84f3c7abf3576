"""Entry-point helpers of the port (counterpart of `repro.launch`): the
meshes (`mesh`), process setup (`platform`), the ETuner LM loop on a
mesh (`train`, run as ``python -m repro_torch.launch.train``), and the
dry run of a cell on the production meshes (`specs`, `dryrun`, run as
``python -m repro_torch.launch.dryrun``)."""
