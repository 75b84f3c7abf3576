"""The port's counterpart of `repro.distributed`: so far only the
straggler tracker the fleet imports. The `shard_map` collectives, elastic
meshes and sharding rules come with ROADMAP A.9."""
