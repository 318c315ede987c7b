"""The SD1.5 LoRA train step: loss, optimizer, LR schedules."""
