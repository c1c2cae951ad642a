"""The LAQ algorithm: quantizer, skip criterion, wire backends, strategy
state machine and the round engine."""
