// Native seqlock channel ops — the hot path of compiled-DAG / pipeline
// edges (reference analog: the mmap'd plasma channels behind
// `python/ray/experimental/channel.py:49,99,135`, whose buffer reuse +
// busy-wait loops live in C++ inside plasma).
//
// Operates IN PLACE on the shm segment the Python `Channel` owns — header
// layout is shared with the pure-Python fallback (experimental/channel.py):
//   [0]        u64 seq     (publish counter; release-stored)
//   [8]        u64 length
//   [16]       u64 flag    (0 normal, 1 stop)
//   [24 + 8k]  u64 ack_k   (reader k's last consumed seq)
//
// Correctness over the Python version: real acquire/release atomics instead
// of GIL-incidental ordering; latency: adaptive spin→yield→sleep instead of
// a fixed 500µs poll.

#include <atomic>
#include <cstdint>
#include <cstring>
#include <ctime>

#include <sched.h>

namespace {

inline std::atomic<uint64_t>* slot(uint8_t* base, uint64_t off) {
    return reinterpret_cast<std::atomic<uint64_t>*>(base + off);
}

inline uint64_t now_us() {
    timespec ts;
    clock_gettime(CLOCK_MONOTONIC, &ts);
    return static_cast<uint64_t>(ts.tv_sec) * 1000000ull + ts.tv_nsec / 1000;
}

inline void cpu_pause() {
#if defined(__x86_64__) || defined(__i386__)
    __builtin_ia32_pause();
#else
    std::atomic_thread_fence(std::memory_order_seq_cst);
#endif
}

// Adaptive waiter: ~20µs of pause-spins, then yields, then 100µs sleeps.
struct Waiter {
    uint64_t spins = 0;
    void wait() {
        if (spins < 2000) {
            cpu_pause();
        } else if (spins < 2200) {
            sched_yield();
        } else {
            timespec ts{0, 100000};  // 100µs
            nanosleep(&ts, nullptr);
        }
        ++spins;
    }
};

}  // namespace

extern "C" {

// Block until every reader acked the previous message, then copy the payload
// and publish. Returns 0 ok, -1 timeout. timeout_us < 0 = infinite.
int64_t rtpu_ch_write(uint8_t* base, uint64_t num_readers,
                      const uint8_t* data, uint64_t len, uint64_t flag,
                      int64_t timeout_us) {
    const uint64_t header = 24 + 8 * num_readers;
    auto* seq_slot = slot(base, 0);
    const uint64_t seq = seq_slot->load(std::memory_order_relaxed);
    const uint64_t deadline = timeout_us < 0 ? 0 : now_us() + timeout_us;
    Waiter w;
    if (seq > 0) {
        for (;;) {
            uint64_t min_ack = UINT64_MAX;
            for (uint64_t k = 0; k < num_readers; ++k) {
                const uint64_t a =
                    slot(base, 24 + 8 * k)->load(std::memory_order_acquire);
                if (a < min_ack) min_ack = a;
            }
            if (min_ack >= seq) break;
            if (timeout_us >= 0 && now_us() > deadline) return -1;
            w.wait();
        }
    }
    if (len > 0) std::memcpy(base + header, data, len);
    slot(base, 8)->store(len, std::memory_order_relaxed);
    slot(base, 16)->store(flag, std::memory_order_relaxed);
    seq_slot->store(seq + 1, std::memory_order_release);  // publish
    return 0;
}

// Block until a message newer than last_seq is published; reports its
// length + flag (payload stays in shm — the caller slices it zero-copy).
// Returns 0 ok, -1 timeout.
int64_t rtpu_ch_wait_read(uint8_t* base, uint64_t last_seq,
                          uint64_t* out_len, uint64_t* out_flag,
                          int64_t timeout_us) {
    auto* seq_slot = slot(base, 0);
    const uint64_t deadline = timeout_us < 0 ? 0 : now_us() + timeout_us;
    Waiter w;
    while (seq_slot->load(std::memory_order_acquire) <= last_seq) {
        if (timeout_us >= 0 && now_us() > deadline) return -1;
        w.wait();
    }
    *out_len = slot(base, 8)->load(std::memory_order_relaxed);
    *out_flag = slot(base, 16)->load(std::memory_order_relaxed);
    return 0;
}

// Idempotent absolute ack into this reader's own slot.
void rtpu_ch_ack(uint8_t* base, uint64_t reader_slot_idx, uint64_t seq) {
    slot(base, 24 + 8 * reader_slot_idx)->store(seq, std::memory_order_release);
}

}  // extern "C"
