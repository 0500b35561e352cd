"""output_tok_s.card_paced: output_tok_s in the cells whose pace the
card sets (its busy share near 90%), which repeat within about 2% and so
carry a bound of their own."""

from portbench.metrics_common import output_tok_s as read  # noqa: F401
