"""Multi-process scale-out: the rays of a pass or a training batch split
over the ranks of a ``torch.distributed`` process group
(``sharding.py``)."""
