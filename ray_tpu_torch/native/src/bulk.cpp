// Native bulk-plane landing — the receive half of core/bulk.py off the GIL.
//
// Why this exists: the pipelined Python landing (ChunkPipeline) interleaves a
// reader thread (recv_into) and lander thread(s) (pwrite) through the GIL. On
// CPU-starved hosts the GIL handoff per chunk serializes what the window was
// built to overlap — the in-cluster 8 GiB pull measured 0.68-0.74 GiB/s while
// the same syscalls issued from ONE native loop measure 1.1+ (see
// docs/ROOFLINE_put_path.md "in-cluster host scheduling" section). Two paths:
//
//  1. rt_bulk_land_stream — the whole span lands in one native call: a
//     poll/read/pwrite loop between the socket fd and the destination file at
//     its offset. The payload never passes through Python; ctypes releases
//     the GIL for the duration. Per-iteration poll() enforces the same
//     PROGRESS deadline `transfer_chunk_timeout_s` gives the Python path
//     (any byte of progress re-arms it).
//
//  2. rt_lander_* — a pinned lander thread consuming (buf, dst_off, len)
//     descriptors from a bounded SPSC ring: Python keeps doing the recv_into
//     (released GIL, deep rcvbuf) while the landing pwrites run entirely
//     native. For hosts with spare cores this preserves the recv/land
//     overlap WITHOUT a Python lander thread in the GIL rotation. Completion
//     is strictly FIFO (single consumer), so the Python side can recycle
//     chunk buffers by watermark. Synchronization is atomics + an adaptive
//     yield/sleep waiter (channel.cpp idiom) — no mutex/condvar, which also
//     keeps the TSAN harness (native_stress_test.cpp) clean of libstdc++
//     condition_variable interception artifacts. At 8-32 MiB chunk
//     granularity the 100µs sleep quantum is noise.
//
// Failure semantics mirror core/bulk.py exactly (chaos-tested there): a
// stalled peer -> -ETIMEDOUT within the progress deadline; a peer closing
// mid-span -> -EPIPE; a landing write error -> its -errno. The caller aborts
// its writer, so no partial object becomes visible. rt_lander_close() poisons
// the ring; if the lander is STUCK inside a pwrite past the deadline the
// handle and thread are deliberately leaked (return 1) — the Python side then
// leaks the chunk buffers too, because freeing memory a kernel call may still
// land into would be a use-after-free (same contract as the Python
// pipeline's stuck-lander abort).

#include <atomic>
#include <cerrno>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <ctime>
#include <thread>
#include <vector>

#include <poll.h>
#include <sched.h>
#include <unistd.h>

namespace {

// One read()'s worth of staging for the stream path. 4 MiB keeps the
// buffer cache-adjacent while costing only ~2k syscall pairs per 8 GiB.
constexpr size_t kStreamBuf = 4 << 20;

inline uint64_t now_ms() {
    timespec ts;
    clock_gettime(CLOCK_MONOTONIC, &ts);
    return static_cast<uint64_t>(ts.tv_sec) * 1000ull + ts.tv_nsec / 1000000;
}

// Adaptive waiter for chunk-granularity events: a few yields, then 100µs
// sleeps (channel.cpp's Waiter, minus the spin phase — chunk landings are
// milliseconds apart, so burning pause-spins would only steal the sibling
// thread's cycles on small hosts).
struct Waiter {
    uint64_t rounds = 0;
    void wait() {
        if (rounds < 64) {
            sched_yield();
        } else {
            timespec ts{0, 100000};  // 100µs
            nanosleep(&ts, nullptr);
        }
        ++rounds;
    }
};

int pwrite_full(int fd, const char* buf, size_t len, uint64_t off) {
    size_t done = 0;
    while (done < len) {
        ssize_t m = pwrite(fd, buf + done, len - done, (off_t)(off + done));
        if (m < 0) {
            if (errno == EINTR) continue;
            return -errno;
        }
        if (m == 0) return -EIO;
        done += (size_t)m;
    }
    return 0;
}

}  // namespace

extern "C" {

// Land `len` bytes from `sock_fd` into `dst_fd` at `dst_off`. Returns bytes
// landed (== len) on success, negative errno on failure:
//   -ETIMEDOUT  no socket progress within deadline_ms (stalled peer)
//   -EPIPE      peer closed mid-span
//   other       read()/pwrite() errno
// Works with the socket in blocking OR non-blocking mode (poll gates reads).
long long rt_bulk_land_stream(int sock_fd, int dst_fd,
                              unsigned long long dst_off,
                              unsigned long long len, int deadline_ms) {
    char* buf = (char*)malloc(kStreamBuf);
    if (buf == nullptr) return -ENOMEM;
    unsigned long long got = 0;
    while (got < len) {
        pollfd pfd{sock_fd, POLLIN, 0};
        int pr = poll(&pfd, 1, deadline_ms);
        if (pr < 0) {
            if (errno == EINTR) continue;
            int e = errno; free(buf); return -e;
        }
        if (pr == 0) { free(buf); return -ETIMEDOUT; }
        size_t want = len - got > kStreamBuf ? kStreamBuf : (size_t)(len - got);
        ssize_t n = read(sock_fd, buf, want);
        if (n < 0) {
            if (errno == EINTR || errno == EAGAIN || errno == EWOULDBLOCK)
                continue;  // spurious readiness; the poll deadline still arms
            int e = errno; free(buf); return -e;
        }
        if (n == 0) { free(buf); return -EPIPE; }
        int w = pwrite_full(dst_fd, buf, (size_t)n, dst_off + got);
        if (w != 0) { free(buf); return w; }
        got += (unsigned long long)n;
    }
    free(buf);
    return (long long)got;
}

// ------------------------------------------------------------- ring lander
// Single-producer (the Python reader) / single-consumer (the lander thread)
// bounded ring. Ring entries are plain data published by the release-store
// of `submitted` and consumed before the release-store of `completed`.
struct LandDesc {
    const char* buf;
    uint64_t off;
    uint64_t len;
};

struct Lander {
    int fd;  // dup'd: the caller may close its fd while we still land
    std::vector<LandDesc> ring;
    size_t depth;
    std::atomic<uint64_t> submitted{0};  // accepted into the ring
    std::atomic<uint64_t> completed{0};  // fully landed (FIFO)
    std::atomic<int> err{0};             // first landing errno (sticky)
    std::atomic<bool> poisoned{false};   // abort: skip pending writes
    std::atomic<bool> exited{false};     // lander thread left its loop
    std::thread th;
};

static void lander_loop(Lander* L) {
    Waiter w;
    for (;;) {
        uint64_t done = L->completed.load(std::memory_order_relaxed);
        while (L->submitted.load(std::memory_order_acquire) == done) {
            if (L->poisoned.load(std::memory_order_acquire)) {
                L->exited.store(true, std::memory_order_release);
                return;
            }
            w.wait();
        }
        w.rounds = 0;
        LandDesc d = L->ring[done % L->depth];
        // After the first error (or a poison) only drain bookkeeping — the
        // transfer is aborting and the buffers may be recycled/freed.
        if (L->err.load(std::memory_order_relaxed) == 0 &&
            !L->poisoned.load(std::memory_order_acquire)) {
            int rc = pwrite_full(L->fd, d.buf, (size_t)d.len, d.off);
            if (rc != 0) {
                int expect = 0;
                L->err.compare_exchange_strong(expect, -rc);
            }
        }
        L->completed.store(done + 1, std::memory_order_release);
    }
}

void* rt_lander_create(int dst_fd, int depth) {
    if (depth < 1) depth = 1;
    int fd = dup(dst_fd);
    if (fd < 0) return nullptr;
    Lander* L = new Lander();
    L->fd = fd;
    L->depth = (size_t)depth;
    L->ring.resize(L->depth);
    L->th = std::thread(lander_loop, L);
    return L;
}

// Queue one filled chunk. Blocks while the ring is full (bounded window).
// Returns the 1-based submission count, -ETIMEDOUT if no slot freed within
// timeout_ms (stalled landing), or the sticky landing error as -errno.
long long rt_lander_submit(void* h, const void* buf,
                           unsigned long long dst_off, unsigned long long len,
                           int timeout_ms) {
    Lander* L = (Lander*)h;
    if (L->poisoned.load(std::memory_order_acquire)) return -EINVAL;
    const uint64_t deadline = now_ms() + (uint64_t)(timeout_ms > 0 ? timeout_ms : 0);
    Waiter w;
    uint64_t sub = L->submitted.load(std::memory_order_relaxed);
    while (sub - L->completed.load(std::memory_order_acquire) >= L->depth) {
        int e = L->err.load(std::memory_order_relaxed);
        if (e != 0) return -(long long)e;
        if (now_ms() > deadline) return -ETIMEDOUT;
        w.wait();
    }
    int e = L->err.load(std::memory_order_relaxed);
    if (e != 0) return -(long long)e;
    L->ring[sub % L->depth] = LandDesc{(const char*)buf, dst_off, len};
    L->submitted.store(sub + 1, std::memory_order_release);
    return (long long)(sub + 1);
}

// Wait until at least `target` chunks have landed. 0 ok, -ETIMEDOUT, or the
// sticky landing error as -errno.
int rt_lander_wait(void* h, unsigned long long target, int timeout_ms) {
    Lander* L = (Lander*)h;
    const uint64_t deadline = now_ms() + (uint64_t)(timeout_ms > 0 ? timeout_ms : 0);
    Waiter w;
    while (L->completed.load(std::memory_order_acquire) < target) {
        int e = L->err.load(std::memory_order_relaxed);
        if (e != 0) return -e;
        if (now_ms() > deadline) return -ETIMEDOUT;
        w.wait();
    }
    int e = L->err.load(std::memory_order_relaxed);
    return e != 0 ? -e : 0;
}

long long rt_lander_completed(void* h) {
    Lander* L = (Lander*)h;
    return (long long)L->completed.load(std::memory_order_acquire);
}

int rt_lander_error(void* h) {
    Lander* L = (Lander*)h;
    return L->err.load(std::memory_order_acquire);
}

// Poison and join. Pending un-landed chunks are SKIPPED (close never
// flushes — drain with rt_lander_wait first). Returns 0 when the lander
// exited (handle freed) or 1 when it is stuck past timeout_ms: the thread is
// detached and the handle LEAKED on purpose — it may still be inside a
// pwrite from a submitted buffer, so the caller must keep those buffers
// alive forever (the Python side parks them in a module-level leak list,
// mirroring the Python pipeline's stuck-lander contract).
int rt_lander_close(void* h, int timeout_ms) {
    Lander* L = (Lander*)h;
    L->poisoned.store(true, std::memory_order_release);
    const uint64_t deadline = now_ms() + (uint64_t)(timeout_ms > 0 ? timeout_ms : 0);
    Waiter w;
    while (!L->exited.load(std::memory_order_acquire)) {
        if (now_ms() > deadline) {
            L->th.detach();
            return 1;
        }
        w.wait();
    }
    L->th.join();
    close(L->fd);
    delete L;
    return 0;
}

}  // extern "C"
