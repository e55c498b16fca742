"""The LM side: config-driven transformer blocks (`layers`) and their
assembly into init / prefill / decode / loss (`lm`). Only the dense family
is ported so far (ROADMAP.md, queue 1, item 6)."""
