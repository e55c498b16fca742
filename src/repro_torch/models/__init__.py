"""The LM side: config-driven transformer and SSM blocks (`layers`) and
their assembly into init / prefill / decode / loss (`lm`), for all ten
architectures."""
