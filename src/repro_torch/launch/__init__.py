"""Entry-point helpers of the port (counterpart of `repro.launch`): the
meshes (`mesh`), process setup (`platform`) and the ETuner LM loop on a
mesh (`train`, run as ``python -m repro_torch.launch.train``)."""
