"""Multi-device scaling: device meshes, sharded hashing, sharded grouping,
and the file and hash exchange between processes."""
