"""Data parallelism, the model axis's sharded state and the pipeline over
``torch.distributed`` (port of msla_tpu/parallel/: ``mesh.py``,
``distributed.py``, ``launch.py`` and ``pipeline.py``).

One process a card, the rank's share of the global batch on it. ``launch``
starts the ranks, ``distributed.setup_distributed`` joins them into a
process group (NCCL on the card, gloo on the CPU), ``mesh`` lays them out on
a (data, model) grid and holds the collectives the Trainer and the tasks
need, ``sharding`` keeps each rank's blocks of the parameters and of the
Adam moments under ``model_parallel``, ``zero1`` and ``fsdp``, and
``pipeline`` runs GPipe over the model groups under ``pipeline_parallel``.
"""
