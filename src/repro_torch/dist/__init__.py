"""The sharded sweep layer over ``torch.distributed``: the active mesh
and the ``"slices"`` rule (``sharding``), and sharded sweeps, padded
launches and the training partition (``sweep``)."""
