"""Distribution of the model over devices: the logical-axis sharding rules
and the static stage partition (``sharding``), the dry-run's block-level
cost analysis and per-layer serving costs for balanced cuts
(``blockwise``), roofline terms, collective and FLOP accounting
(``roofline``) and the stage-parallel FWS pipeline over a (replica,
stage) grid of devices (``pipeline_exec``). The rules describe the
reference's GSPMD shardings for the dry-run; no step runs sharded over
``torch.distributed`` yet (``ROADMAP.md``)."""
