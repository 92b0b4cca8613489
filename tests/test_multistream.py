"""Multi-stream sharded encode on the virtual CPU mesh: identical
bitstreams to independent single-stream encodes."""
import numpy as np

from x265_mod_by_patman_tpu.params import default_params
from x265_mod_by_patman_tpu.encoder.top import Encoder
from x265_mod_by_patman_tpu.parallel.streams import MultiStreamIntraEncoder
from x265_mod_by_patman_tpu.decoder.decoder import Decoder
from tests.test_e2e_intra import synth_frame


def test_sharded_streams_match_single(virtual_mesh):
    w, h = 64, 64
    n = 4
    p = default_params(w, h, qp=32, keyframe_max=1, rd_level=2)
    streams = [[synth_frame(w, h, seed=s * 7 + t, motion=t)
                for t in range(2)] for s in range(n)]

    ms = MultiStreamIntraEncoder(p, n)
    sharded = [ms.encode_step([streams[s][t] for s in range(n)])
               for t in range(2)]

    for s in range(n):
        enc = Encoder(default_params(w, h, qp=32, keyframe_max=1,
                                     rd_level=2))
        for t in range(2):
            [f] = enc.encode_frame(*streams[s][t])
            assert f.bitstream == sharded[t][s].bitstream, (s, t)
            assert f.md5 == sharded[t][s].md5
        stream_bytes = b"".join(sharded[t][s].bitstream for t in range(2))
        pics = Decoder().decode(stream_bytes)
        for t in range(2):
            assert pics[t].md5 == sharded[t][s].md5 == pics[t].sei_md5
