"""copied_mb.weak4: MiB the mesh's collectives copied between cards in
the last call (parallel.mesh.copied, reset before each call)."""


def read(run):
    b = getattr(run.entry, "copied_bytes", None)
    return None if b is None else b / (1 << 20)
