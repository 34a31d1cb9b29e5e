"""Training over several processes (counterpart of
``disentangled_multimodal_learning_tpu/parallel/``): the process group and
the data-parallel layout (``mesh``), TransMIL's token axis sharded
(``seq_shard``), the 2-D deformable attention's heads sharded
(``tp_shard``), the two magnifications on their own ranks
(``branch_shard``) and distillation as a two-stage pipeline
(``pipe_shard``)."""
