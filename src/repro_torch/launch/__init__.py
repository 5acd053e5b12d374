"""Process groups and meshes of the multi-device search (`launch.mesh`)."""
