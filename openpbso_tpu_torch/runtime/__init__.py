"""Block solver, carried state, the host session, the streaming engine and
the TCP/WebSocket audio servers of the port (the post-mixes a stream may
carry are ``ops.DopplerPostMix`` and ``ops.HRTFPostMix``)."""
from .audio import (RawCollectorSink, RealTimePacerSink, SoundDeviceSink,
                    WavFileSink)
from .checkpoint import (load_session, load_state, save_session, save_state,
                         swap_model)
from .engine import StreamingEngine
from .profiling import BlockProfiler
from .session import ModalSession
from .solver import (SolverConfig, default_gains, step_block, step_multi,
                     step_multi_transfers, step_multi_transfers_sound)
from .state import SolverState, make_solver_state
