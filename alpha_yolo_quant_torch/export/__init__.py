"""Hardware-contract exporters: Verilog-formatted text artifacts, gzip
pickle weight files, LUT tables, first-pixel traces, and the packed
state-dict, format-compatible with the reference's RTL bring-up flow."""
