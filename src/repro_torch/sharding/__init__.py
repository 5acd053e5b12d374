"""How the search state lays out over a mesh (`sharding.search`)."""
