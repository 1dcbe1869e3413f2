"""The port of adaptigraph_tpu/sim: so far the episode property params
(`episode_io`). The simulation app comes with the data-generation slice."""
