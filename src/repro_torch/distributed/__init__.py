"""The mesh layer: sharding rules and the mesh context (DTensor placements)."""
