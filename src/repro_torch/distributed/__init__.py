"""The port's counterpart of `repro.distributed`, on `torch.distributed`:
the straggler tracker the fleet imports, the sharding rules
(`sharding`: specs, DTensor placements, activation hints), the gradient
collectives (`collectives`), elastic re-meshing (`elastic`) and the
sharded LM step's layer (`spmd`)."""
