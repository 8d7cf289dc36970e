"""Distribution of the model over chips (so far only the static stage
partition; the stage-parallel executor is ROADMAP.md Queue 1 item 9)."""
