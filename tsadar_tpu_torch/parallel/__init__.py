"""Multi-GPU sharding over ``torch.distributed``: one rank per device (``dist``)."""
