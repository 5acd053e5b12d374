"""Launchers of the port: process groups and meshes of the multi-device
search (`launch.mesh`) and the LM training launcher (`launch.train`)."""
