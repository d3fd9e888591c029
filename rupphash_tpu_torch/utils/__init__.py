"""Host utilities: content hashing, file identity, solar position, fileops."""
