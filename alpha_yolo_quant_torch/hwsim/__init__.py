"""Hardware modelling: on-chip SRAM allocation simulator (host Python,
no device)."""
