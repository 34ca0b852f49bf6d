"""Parallelism helpers of the port: the tensor-parallel reduction points
(``actshard``) and the serving rule that names which dimension of a
parameter shards (``sharding``)."""
