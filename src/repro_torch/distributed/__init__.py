"""Distribution of the model over devices: the device mesh, over cards or
over a process group's ranks (``mesh``), the logical-axis sharding rules
and the static stage partition (``sharding``), the dry-run's block-level
cost analysis and per-layer serving costs for balanced cuts
(``blockwise``), roofline terms, collective and FLOP accounting
(``roofline``) and the stage-parallel FWS pipeline over a (replica,
stage) grid of devices (``pipeline_exec``). The rules describe the
reference's GSPMD shardings for the dry-run, and the sharded train and
serving steps run them over ``torch.distributed`` through the
collectives of ``collectives``: FSDP and ZeRO-1 on the data axes, on
``model`` the tensor-parallel layers of ``tensor_parallel``, and the
decode over a cache whose sequence is cut over ranks
(``seq_parallel``)."""
