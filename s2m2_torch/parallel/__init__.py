"""Multi-device runs of the port: a ('data', 'band') mesh of
`torch.distributed` ranks (`mesh`, `distributed`), the collectives of the
band-sharded forward (`band`) and a launcher of local ranks (`launch`)."""
