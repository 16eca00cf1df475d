"""The port's models: the serving path (prefill and decode) of the dense
(``transformer``, attention through the flash-attention kernel) and ssm
(``rwkv6``, the WKV recurrence through the WKV6 kernel) families."""
