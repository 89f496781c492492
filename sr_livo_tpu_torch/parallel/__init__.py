"""Mapping backend of the port: pose graph, windowed BA, loop closure
and the MappingBackend that attaches them to a LivoPipeline."""
