"""Data parallelism over ``torch.distributed`` (port of msla_tpu/parallel/: the
data axis of ``mesh.py``, ``distributed.py`` and ``launch.py``).

One process a card, the rank's share of the global batch on it; the Trainer
averages the gradients over the ranks. ``launch`` starts the ranks,
``distributed.setup_distributed`` joins them into a process group (NCCL on
the card, gloo on the CPU) and ``mesh`` answers who is who and holds the
collectives the Trainer and the tasks need.
"""
