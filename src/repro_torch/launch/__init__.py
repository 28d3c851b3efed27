"""Process groups and meshes for the sharded engine (:mod:`.mesh`)."""
