"""Distribution of the model over devices: the static stage partition
(``sharding.stage_partition``), per-layer serving costs for balanced
cuts (``blockwise.serve_layer_costs``), collective and FLOP accounting
(``roofline``) and the stage-parallel FWS pipeline over a (replica,
stage) grid of devices (``pipeline_exec``). The reference's GSPMD
sharding rules, its XLA cost and HLO readers and its mesh launcher serve
the dry-run and training tools and are not ported yet (ROADMAP.md Queue
1 item 4)."""
