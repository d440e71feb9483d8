"""Block solver, carried state, the host session and the streaming engine of
the port."""
from .audio import (RawCollectorSink, RealTimePacerSink, SoundDeviceSink,
                    WavFileSink)
from .checkpoint import (load_session, load_state, save_session, save_state,
                         swap_model)
from .engine import StreamingEngine
from .profiling import BlockProfiler
from .session import ModalSession
from .solver import SolverConfig, default_gains, step_block, step_multi
from .state import SolverState, make_solver_state
