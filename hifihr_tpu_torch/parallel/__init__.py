"""Multi-rank training over torch.distributed (counterpart of
hifihr_tpu/parallel/): `mesh.py` holds the process groups, the batch
sharding and the replication; `launch.py` runs a function on N local
ranks."""
