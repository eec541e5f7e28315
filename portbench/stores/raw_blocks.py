"""The program's in-memory store holding every block of the world, with the
raw map its fused C scan reads (``fixtures.world_from_blocks``)."""


def load(world):
    """``(store, pairs)``: the world's blocks in the program's store, and
    its tipset pairs as the program's objects."""
    from ipc_proofs_tpu_torch.fixtures import world_from_blocks

    return world_from_blocks(world.blocks.items(), world.pairs)
