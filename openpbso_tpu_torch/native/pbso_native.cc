// pbso_native — native runtime support for the modal sound engine.
//
// Two components, exposed through a C ABI for ctypes:
//
// 1. A wait-free single-producer/single-consumer ring of fixed-size audio
//    blocks. This is the counterpart of the reference's vendored
//    moodycamel SPSC queues (external/readerwriterqueue.h): the synthesis
//    thread pushes device-computed blocks, the audio callback pops them,
//    and neither side ever takes a lock or allocates. Unlike the Python
//    queue.Queue fallback it has no GIL involvement on the audio side when
//    driven from a native callback.
//
// 2. A fast decoder for the `.fatcube` protobuf wire format
//    (ffat_map.proto) that scans the buffer once and memcpy's packed
//    doubles straight into caller-provided arrays. The pure-Python codec in
//    io/fatcube.py is the reference implementation; this one exists for
//    bulk-loading hundred-model datasets.
//
// Build: native/bindings.py compiles this file with g++ at first use into
// openpbso_tpu_torch/_build/ (cached by a hash of the source and flags).

#include <atomic>
#include <cstdint>
#include <cstring>
#include <new>

extern "C" {

// ---------------------------------------------------------------------------
// SPSC block ring
// ---------------------------------------------------------------------------

struct SpscRing {
  float*  data;        // capacity * block_floats
  int64_t capacity;    // number of block slots (power of two not required)
  int64_t block_floats;
  std::atomic<int64_t> head;  // next slot to write (producer-owned)
  std::atomic<int64_t> tail;  // next slot to read (consumer-owned)
  std::atomic<int64_t> dropped;
};

SpscRing* spsc_create(int64_t capacity, int64_t block_floats) {
  if (capacity <= 0 || block_floats <= 0) return nullptr;
  auto* r = new (std::nothrow) SpscRing();
  if (!r) return nullptr;
  r->data = new (std::nothrow) float[capacity * block_floats]();
  if (!r->data) { delete r; return nullptr; }
  r->capacity = capacity;
  r->block_floats = block_floats;
  r->head.store(0, std::memory_order_relaxed);
  r->tail.store(0, std::memory_order_relaxed);
  r->dropped.store(0, std::memory_order_relaxed);
  return r;
}

void spsc_destroy(SpscRing* r) {
  if (!r) return;
  delete[] r->data;
  delete r;
}

// try_push: returns 1 on success, 0 when full (caller decides: spin for the
// pacing queue like the reference's NoFail enqueue, or drop for telemetry).
int spsc_try_push(SpscRing* r, const float* block) {
  const int64_t head = r->head.load(std::memory_order_relaxed);
  const int64_t tail = r->tail.load(std::memory_order_acquire);
  if (head - tail >= r->capacity) return 0;  // full
  std::memcpy(r->data + (head % r->capacity) * r->block_floats, block,
              sizeof(float) * r->block_floats);
  r->head.store(head + 1, std::memory_order_release);
  return 1;
}

// push_overwrite: drop-oldest semantics (the reference's capacity-1
// transfer queue *behavior*: a newer value replaces the pending one).
// The producer must NEVER write a published slot — the consumer may be
// mid-copy of ANY slot in [tail, head), not just the one tail pointed at
// when we looked (an earlier version overwrote head-1 in place, which
// races exactly that way). Instead, on full the producer RETIRES the
// oldest slot by advancing tail with a CAS; the consumer's pop validates
// its copy with the same CAS and discards a potentially-stale copy when
// it loses. The head slot it then writes is unpublished by definition.
void spsc_push_overwrite(SpscRing* r, const float* block) {
  for (;;) {
    if (spsc_try_push(r, block)) return;
    int64_t t = r->tail.load(std::memory_order_relaxed);
    const int64_t head = r->head.load(std::memory_order_relaxed);
    if (head - t < r->capacity) continue;  // consumer made room; retry
    if (r->tail.compare_exchange_strong(t, t + 1,
                                        std::memory_order_acq_rel)) {
      r->dropped.fetch_add(1, std::memory_order_relaxed);
    }
    // CAS lost => the consumer freed a slot concurrently; retry either way
  }
}

// try_pop: returns 1 on success, 0 when empty (audio side replays stale).
// The copy-then-CAS order pairs with push_overwrite's tail skip: if the
// producer retired the slot we were copying, our CAS fails and the
// (possibly torn) copy is discarded before anyone sees it.
int spsc_try_pop(SpscRing* r, float* out) {
  for (;;) {
    int64_t tail = r->tail.load(std::memory_order_relaxed);
    const int64_t head = r->head.load(std::memory_order_acquire);
    if (tail >= head) return 0;  // empty
    std::memcpy(out, r->data + (tail % r->capacity) * r->block_floats,
                sizeof(float) * r->block_floats);
    if (r->tail.compare_exchange_strong(tail, tail + 1,
                                        std::memory_order_acq_rel))
      return 1;
  }
}

int64_t spsc_size(SpscRing* r) {
  return r->head.load(std::memory_order_acquire)
       - r->tail.load(std::memory_order_acquire);
}

int64_t spsc_dropped(SpscRing* r) {
  return r->dropped.load(std::memory_order_relaxed);
}

// ---------------------------------------------------------------------------
// fatcube wire decoder
// ---------------------------------------------------------------------------

namespace {

struct Cursor {
  const uint8_t* p;
  const uint8_t* end;
  bool ok = true;

  uint64_t varint() {
    uint64_t v = 0;
    int shift = 0;
    while (p < end && shift <= 63) {
      const uint8_t b = *p++;
      v |= static_cast<uint64_t>(b & 0x7F) << shift;
      if (!(b & 0x80)) return v;
      shift += 7;
    }
    ok = false;
    return 0;
  }

  double f64() {
    if (end - p < 8) { ok = false; return 0.0; }
    double v;
    std::memcpy(&v, p, 8);
    p += 8;
    return v;
  }

  Cursor sub(uint64_t len) {
    if (static_cast<uint64_t>(end - p) < len) {
      ok = false;
      return Cursor{end, end};
    }
    Cursor c{p, p + len};
    p += len;
    return c;
  }

  void skip(int wire_type) {
    switch (wire_type) {
      case 0: varint(); break;
      case 1:
        if (end - p < 8) ok = false; else p += 8;
        break;
      case 2: {
        // bound-check BEFORE advancing: a hostile ~2^64 length would
        // wrap the pointer past any after-the-fact p > end test
        const uint64_t n = varint();
        if (static_cast<uint64_t>(end - p) < n) ok = false; else p += n;
        break;
      }
      case 5:
        if (end - p < 4) ok = false; else p += 4;
        break;
      default: ok = false;
    }
  }
};

// packed (or repeated) doubles -> out (up to max), returns count seen,
// or -1 on malformed input (truncated payload, non-multiple-of-8 packed
// length — np.frombuffer raises for the same bytes in the Python codec)
int64_t read_vec(Cursor c, double* out, int64_t max) {
  int64_t n = 0;
  while (c.ok && c.p < c.end) {
    const uint64_t key = c.varint();
    const int wt = key & 7;
    if ((key >> 3) == 1 && wt == 2) {
      Cursor payload = c.sub(c.varint());
      if (!c.ok || (payload.end - payload.p) % 8 != 0) return -1;
      const int64_t cnt = (payload.end - payload.p) / 8;
      const int64_t take = (n + cnt > max) ? (max - n) : cnt;
      if (out && take > 0) std::memcpy(out + n, payload.p, take * 8);
      n += cnt;
    } else if ((key >> 3) == 1 && wt == 1) {
      const double v = c.f64();
      if (out && n < max) out[n] = v;
      ++n;
    } else {
      c.skip(wt);
    }
  }
  return c.ok ? n : -1;
}

// returns count seen, or -1 on malformed input
int64_t read_vec_i(Cursor c, int32_t* out, int64_t max) {
  int64_t n = 0;
  while (c.ok && c.p < c.end) {
    const uint64_t key = c.varint();
    const int wt = key & 7;
    if ((key >> 3) == 1 && wt == 2) {
      Cursor payload = c.sub(c.varint());
      while (payload.ok && payload.p < payload.end) {
        const int64_t v = static_cast<int64_t>(payload.varint());
        if (out && n < max) out[n] = static_cast<int32_t>(v);
        ++n;
      }
    } else if ((key >> 3) == 1 && wt == 0) {
      const int64_t v = static_cast<int64_t>(c.varint());
      if (out && n < max) out[n] = static_cast<int32_t>(v);
      ++n;
    } else {
      c.skip(wt);
    }
  }
  return c.ok ? n : -1;
}

}  // namespace

struct FatcubeOut {
  double  k;
  int32_t mode_id;
  int32_t is_compressed;
  double  cell_size;
  double  map_center[3];     // ffat_map_t_3 field 2 (map-level center)
  double  shell_center[3];   // ffat_map_t_1 field 5 (shell center)
  double  bbox_low[3];
  double  bbox_top[3];
  double  low_corners[18];   // 6 x 3
  int32_t n_elements[12];    // 6 x 2
  int32_t strides[6];
  int64_t psi_count;         // actual count (may exceed psi_capacity)
  double* psi;               // caller-provided
  int64_t psi_capacity;
};

// decode a serialized ffat_map_double; returns 1 on success.
int fatcube_decode(const uint8_t* buf, int64_t len, FatcubeOut* out) {
  if (!buf || !out || len <= 0) return 0;
  Cursor top{buf, buf + len};
  Cursor map3{nullptr, nullptr};
  bool have_map3 = false;
  while (top.ok && top.p < top.end) {
    const uint64_t key = top.varint();
    if ((key >> 3) == 1 && (key & 7) == 2) {
      map3 = top.sub(top.varint());
      have_map3 = true;
    } else {
      top.skip(key & 7);
    }
  }
  if (!top.ok || !have_map3) return 0;

  out->psi_count = 0;
  bool bad = false;  // nested decode failures must fail the WHOLE decode:
  // a partially-zeroed map silently feeding transfer lookups is worse
  // than falling back to the Python codec (which raises for these bytes)
  // missing center fields decode to zeros, matching the Python codec
  // (io/fatcube.py:239,276)
  for (int i = 0; i < 3; ++i) out->map_center[i] = out->shell_center[i] = 0.0;
  while (map3.ok && map3.p < map3.end) {
    const uint64_t key = map3.varint();
    const int field = key >> 3;
    const int wt = key & 7;
    if (field == 1 && wt == 1) {
      out->k = map3.f64();
    } else if (field == 2 && wt == 2) {
      if (read_vec(map3.sub(map3.varint()), out->map_center, 3) < 0)
        bad = true;
    } else if (field == 3 && wt == 2) {          // shells (ffat_map_t_1)
      Cursor sh = map3.sub(map3.varint());
      int lc = 0, ne = 0;
      while (sh.ok && sh.p < sh.end) {
        const uint64_t k2 = sh.varint();
        const int f2 = k2 >> 3;
        const int w2 = k2 & 7;
        if (f2 == 1 && w2 == 1) {
          out->cell_size = sh.f64();
        } else if (f2 == 2 && w2 == 2) {         // lowcorners: mat of vec
          Cursor mat = sh.sub(sh.varint());
          while (mat.ok && mat.p < mat.end) {
            const uint64_t k3 = mat.varint();
            if ((k3 >> 3) == 1 && (k3 & 7) == 2 && lc < 6) {
              if (read_vec(mat.sub(mat.varint()),
                           out->low_corners + 3 * lc, 3) < 0)
                bad = true;
              ++lc;
            } else {
              mat.skip(k3 & 7);
            }
          }
          if (!mat.ok) bad = true;
        } else if (f2 == 3 && w2 == 2) {         // n_elements: mat_i
          Cursor mat = sh.sub(sh.varint());
          while (mat.ok && mat.p < mat.end) {
            const uint64_t k3 = mat.varint();
            if ((k3 >> 3) == 1 && (k3 & 7) == 2 && ne < 6) {
              if (read_vec_i(mat.sub(mat.varint()),
                             out->n_elements + 2 * ne, 2) < 0)
                bad = true;
              ++ne;
            } else {
              mat.skip(k3 & 7);
            }
          }
          if (!mat.ok) bad = true;
        } else if (f2 == 4 && w2 == 2) {
          if (read_vec_i(sh.sub(sh.varint()), out->strides, 6) < 0)
            bad = true;
        } else if (f2 == 5 && w2 == 2) {
          if (read_vec(sh.sub(sh.varint()), out->shell_center, 3) < 0)
            bad = true;
        } else if (f2 == 6 && w2 == 2) {
          if (read_vec(sh.sub(sh.varint()), out->bbox_low, 3) < 0)
            bad = true;
        } else if (f2 == 7 && w2 == 2) {
          if (read_vec(sh.sub(sh.varint()), out->bbox_top, 3) < 0)
            bad = true;
        } else {
          sh.skip(w2);
        }
      }
      if (!sh.ok) bad = true;
    } else if (field == 4 && wt == 0) {
      out->is_compressed = static_cast<int32_t>(map3.varint());
    } else if (field == 5 && wt == 2) {          // psi: mat
      // keep only the FIRST column, matching the Python codec and the
      // reference writer (Psi is serialized as a single [N,1] column,
      // ffat_map_serialize.h:149-159); later columns are skipped
      Cursor mat = map3.sub(map3.varint());
      bool have_col = false;
      while (mat.ok && mat.p < mat.end) {
        const uint64_t k3 = mat.varint();
        if ((k3 >> 3) == 1 && (k3 & 7) == 2) {
          Cursor col = mat.sub(mat.varint());
          if (!have_col) {
            const int64_t cnt = read_vec(col, out->psi, out->psi_capacity);
            if (cnt < 0) bad = true; else out->psi_count = cnt;
            have_col = true;
          }
        } else {
          mat.skip(k3 & 7);
        }
      }
      if (!mat.ok) bad = true;
    } else if (field == 6 && wt == 0) {
      out->mode_id = static_cast<int32_t>(map3.varint());
    } else {
      map3.skip(wt);
    }
  }
  return (map3.ok && !bad) ? 1 : 0;
}

}  // extern "C"
