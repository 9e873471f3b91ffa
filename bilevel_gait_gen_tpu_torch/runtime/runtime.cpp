// Native real-time runtime for the host side of the controller (the port's
// own copy of bilevel_gait_gen_tpu/runtime/runtime.cpp, built by
// bilevel_gait_gen_tpu_torch/runtime/__init__.py with g++).
//
// Replacement for the reference's hand-rolled concurrency and hardware I/O
// plumbing:
//  * triple buffer  <- the 5-mutex trajectory handoff between the 1 kHz
//    control thread and the free-running MPC thread
//    (controllers/mpc_controller.h:99-103) — wait-free single-producer/
//    single-consumer, the reader always sees the latest complete snapshot;
//  * rate loop      <- UNITREE_LEGGED_SDK::LoopFunc periodic threads
//    (hardware/hardware_interface.cpp:143-150) — absolute-deadline
//    clock_nanosleep with overrun accounting;
//  * low-pass bank  <- HardwareRobot::LPF chains on v_com/a_com/v_joints/
//    GRF (hardware/hardware_robot.cpp:153-180, 676-681);
//  * UDP endpoint   <- the Unitree UDP driver's socket layer
//    (hardware/unitree_lib/udp.h) — nonblocking datagram I/O the Python
//    hardware layer frames packets over.
//
// Exposed as a tiny C ABI consumed via ctypes (no pybind11 in this image).
#include <atomic>
#include <chrono>
#include <cstdint>
#include <cstring>
#include <ctime>
#include <vector>

#include <arpa/inet.h>
#include <fcntl.h>
#include <sys/socket.h>
#include <unistd.h>

extern "C" {

// ---------------------------------------------------------------------------
// Triple buffer (wait-free SPSC latest-value channel)
// ---------------------------------------------------------------------------
struct TripleBuffer {
    std::vector<double> buf[3];
    // index state: 2 bits each for front, middle, back + dirty flag in bit 6
    std::atomic<uint32_t> state;
    size_t size;
};

TripleBuffer* bgg_tb_create(size_t n_doubles) {
    auto* tb = new TripleBuffer();
    for (auto& b : tb->buf) b.assign(n_doubles, 0.0);
    tb->size = n_doubles;
    tb->state.store(0u | (1u << 2) | (2u << 4), std::memory_order_relaxed);
    return tb;
}

void bgg_tb_destroy(TripleBuffer* tb) { delete tb; }

// producer: write a full snapshot, then publish (swap back <-> middle)
void bgg_tb_write(TripleBuffer* tb, const double* src) {
    uint32_t st = tb->state.load(std::memory_order_relaxed);
    uint32_t back = (st >> 4) & 3u;
    std::memcpy(tb->buf[back].data(), src, tb->size * sizeof(double));
    uint32_t expected = st;
    for (;;) {
        uint32_t middle = (expected >> 2) & 3u;
        uint32_t front = expected & 3u;
        uint32_t back_now = (expected >> 4) & 3u;
        uint32_t next = front | (back_now << 2) | (middle << 4) | (1u << 6);
        if (tb->state.compare_exchange_weak(expected, next,
                                            std::memory_order_acq_rel))
            break;
        // retry with refreshed state (consumer may have swapped front)
    }
}

// consumer: fetch latest snapshot; returns 1 if it was fresh since last read
int bgg_tb_read(TripleBuffer* tb, double* dst) {
    uint32_t expected = tb->state.load(std::memory_order_acquire);
    int fresh = 0;
    for (;;) {
        if (expected & (1u << 6)) {
            uint32_t front = expected & 3u;
            uint32_t middle = (expected >> 2) & 3u;
            uint32_t back = (expected >> 4) & 3u;
            uint32_t next = middle | (front << 2) | (back << 4);
            if (tb->state.compare_exchange_weak(expected, next,
                                                std::memory_order_acq_rel)) {
                fresh = 1;
                break;
            }
        } else {
            break;
        }
    }
    uint32_t front = tb->state.load(std::memory_order_acquire) & 3u;
    std::memcpy(dst, tb->buf[front].data(), tb->size * sizeof(double));
    return fresh;
}

// ---------------------------------------------------------------------------
// Rate loop: absolute-deadline periodic sleeping
// ---------------------------------------------------------------------------
struct RateLoop {
    struct timespec next;
    int64_t period_ns;
    int64_t overruns;
    int64_t ticks;
};

RateLoop* bgg_rate_create(double period_s) {
    auto* rl = new RateLoop();
    rl->period_ns = (int64_t)(period_s * 1e9);
    rl->overruns = 0;
    rl->ticks = 0;
    clock_gettime(CLOCK_MONOTONIC, &rl->next);
    return rl;
}

void bgg_rate_destroy(RateLoop* rl) { delete rl; }

// sleep until the next deadline; returns lateness in ns (>0 = overrun)
int64_t bgg_rate_wait(RateLoop* rl) {
    rl->next.tv_nsec += rl->period_ns;
    while (rl->next.tv_nsec >= 1000000000L) {
        rl->next.tv_nsec -= 1000000000L;
        rl->next.tv_sec += 1;
    }
    struct timespec now;
    clock_gettime(CLOCK_MONOTONIC, &now);
    int64_t late = (now.tv_sec - rl->next.tv_sec) * 1000000000L +
                   (now.tv_nsec - rl->next.tv_nsec);
    if (late > 0) {
        rl->overruns++;
        rl->next = now;  // resync after overrun
    } else {
        clock_nanosleep(CLOCK_MONOTONIC, TIMER_ABSTIME, &rl->next, nullptr);
    }
    rl->ticks++;
    return late;
}

int64_t bgg_rate_overruns(RateLoop* rl) { return rl->overruns; }
int64_t bgg_rate_ticks(RateLoop* rl) { return rl->ticks; }

// ---------------------------------------------------------------------------
// Low-pass filter bank (single-pole; HardwareRobot::LPF semantics)
// ---------------------------------------------------------------------------
struct LPFBank {
    std::vector<double> y;
    double alpha;
    int initialized;
};

LPFBank* bgg_lpf_create(size_t n, double cutoff_hz, double sample_hz) {
    auto* f = new LPFBank();
    f->y.assign(n, 0.0);
    const double pi = 3.14159265358979323846;
    double rc = 1.0 / (2.0 * pi * cutoff_hz);
    double dt = 1.0 / sample_hz;
    f->alpha = dt / (rc + dt);
    f->initialized = 0;
    return f;
}

void bgg_lpf_destroy(LPFBank* f) { delete f; }

void bgg_lpf_step(LPFBank* f, const double* x, double* out) {
    if (!f->initialized) {
        for (size_t i = 0; i < f->y.size(); i++) f->y[i] = x[i];
        f->initialized = 1;
    } else {
        for (size_t i = 0; i < f->y.size(); i++)
            f->y[i] += f->alpha * (x[i] - f->y[i]);
    }
    std::memcpy(out, f->y.data(), f->y.size() * sizeof(double));
}

// ---------------------------------------------------------------------------
// Nonblocking UDP endpoint
// ---------------------------------------------------------------------------
struct UdpEndpoint {
    int fd;
    struct sockaddr_in peer;
};

UdpEndpoint* bgg_udp_create(const char* bind_ip, int bind_port,
                            const char* peer_ip, int peer_port) {
    auto* u = new UdpEndpoint();
    u->fd = socket(AF_INET, SOCK_DGRAM, 0);
    if (u->fd < 0) { delete u; return nullptr; }
    int fl = fcntl(u->fd, F_GETFL, 0);
    fcntl(u->fd, F_SETFL, fl | O_NONBLOCK);
    struct sockaddr_in addr{};
    addr.sin_family = AF_INET;
    addr.sin_port = htons((uint16_t)bind_port);
    addr.sin_addr.s_addr = bind_ip ? inet_addr(bind_ip) : INADDR_ANY;
    if (bind(u->fd, (struct sockaddr*)&addr, sizeof(addr)) < 0) {
        close(u->fd);
        delete u;
        return nullptr;
    }
    u->peer = sockaddr_in{};
    u->peer.sin_family = AF_INET;
    u->peer.sin_port = htons((uint16_t)peer_port);
    u->peer.sin_addr.s_addr = peer_ip ? inet_addr(peer_ip) : 0;
    return u;
}

void bgg_udp_destroy(UdpEndpoint* u) {
    if (u) { close(u->fd); delete u; }
}

long bgg_udp_send(UdpEndpoint* u, const uint8_t* data, size_t len) {
    return sendto(u->fd, data, len, 0, (struct sockaddr*)&u->peer,
                  sizeof(u->peer));
}

long bgg_udp_recv(UdpEndpoint* u, uint8_t* data, size_t maxlen) {
    return recvfrom(u->fd, data, maxlen, 0, nullptr, nullptr);
}

// the port the endpoint is bound to (the one the OS chose for port 0);
// -1 on failure
int bgg_udp_port(UdpEndpoint* u) {
    struct sockaddr_in addr{};
    socklen_t len = sizeof(addr);
    if (getsockname(u->fd, (struct sockaddr*)&addr, &len) < 0) return -1;
    return ntohs(addr.sin_port);
}

// point the endpoint's sends at another peer (two endpoints on ports the OS
// chose learn each other's port only after both are bound)
void bgg_udp_set_peer(UdpEndpoint* u, const char* peer_ip, int peer_port) {
    u->peer = sockaddr_in{};
    u->peer.sin_family = AF_INET;
    u->peer.sin_port = htons((uint16_t)peer_port);
    u->peer.sin_addr.s_addr = peer_ip ? inet_addr(peer_ip) : 0;
}

}  // extern "C"
