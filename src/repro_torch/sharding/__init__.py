"""How state lays out over a mesh: the search state (`sharding.search`);
the LM's rules (`sharding.rules`), spec trees and shards
(`sharding.params`) and a rank's layout in the sharded step
(`sharding.spmd`)."""
