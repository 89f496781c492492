"""The port's parallel and long-run parts: the mapping backend (pose
graph, windowed BA, loop closure, the MappingBackend that attaches them
to a LivoPipeline) and the multi-device engine (mesh, routing, the
map-sharded ShardedLioEngine, the sharded windowed BA, the host x map
mesh), one process per rank over torch.distributed."""
