"""Multi-device paths: the collective layer (mesh), the tile-sharded query
and leapfrog step (sharded) and the LET domain decomposition (let)."""
