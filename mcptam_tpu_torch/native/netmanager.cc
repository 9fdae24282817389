// Network manager: framed TCP messaging with background send/recv
// threads and retry-until-delivered semantics (port of
// mcptam_tpu/native/netmanager.cc, the reference's NetworkManager runtime,
// src/NetworkManager.cc: CVD::Thread send loop + ROS spin thread, blocking
// retry in HandleNextOutgoing :266-302, incoming queue drained by the owner
// thread :305-389).  The wire format is the JAX package's, byte for byte,
// so a process of either package talks to one of the other.
//
// Wire format per message: [u32 magic][u32 action][u64 payload_len]
// [payload bytes].  Payload encoding (numpy arrays) is done in Python
// (system/netcodec.py); this layer owns sockets, threads, queues and
// reconnection.
//
// Build: native/build.py (g++ -O2 -shared -fPIC -pthread, at first use).

#include <arpa/inet.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/socket.h>
#include <unistd.h>

#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

constexpr uint32_t kMagic = 0x4d435054;  // "MCPT"

struct Message {
  uint32_t action;
  std::vector<uint8_t> payload;
};

bool send_all(int fd, const void* buf, size_t n) {
  const uint8_t* p = static_cast<const uint8_t*>(buf);
  while (n > 0) {
    ssize_t w = ::send(fd, p, n, MSG_NOSIGNAL);
    if (w <= 0) return false;
    p += w;
    n -= w;
  }
  return true;
}

bool recv_all(int fd, void* buf, size_t n) {
  uint8_t* p = static_cast<uint8_t*>(buf);
  while (n > 0) {
    ssize_t r = ::recv(fd, p, n, 0);
    if (r <= 0) return false;
    p += r;
    n -= r;
  }
  return true;
}

struct NetManager {
  std::atomic<int> fd{-1};
  std::atomic<bool> running{true};
  std::atomic<bool> is_server{false};
  int listen_fd = -1;
  uint16_t port = 0;
  std::string host;
  // send/receive accounting (the reference keeps per-object send/receive
  // accounting maps, include/mcptam/NetworkManager.h:298-303)
  std::atomic<uint64_t> msgs_sent{0}, msgs_recv{0};
  std::atomic<uint64_t> bytes_sent{0}, bytes_recv{0};
  std::atomic<uint64_t> reconnects{0};

  std::deque<Message> outgoing;
  std::deque<Message> incoming;
  std::mutex out_mu, in_mu, conn_mu;
  std::condition_variable out_cv, in_cv;
  std::thread send_thread, recv_thread, accept_thread;

  ~NetManager() { stop(); }

  void stop() {
    running = false;
    out_cv.notify_all();
    in_cv.notify_all();
    // shutdown (not close) first: wakes threads blocked in recv/accept,
    // then join before releasing the fds to avoid use-after-close races
    int f = fd.load();
    if (f >= 0) ::shutdown(f, SHUT_RDWR);
    if (listen_fd >= 0) ::shutdown(listen_fd, SHUT_RDWR);
    if (send_thread.joinable()) send_thread.join();
    if (recv_thread.joinable()) recv_thread.join();
    if (accept_thread.joinable()) accept_thread.join();
    f = fd.exchange(-1);
    if (f >= 0) ::close(f);
    if (listen_fd >= 0) {
      ::close(listen_fd);
      listen_fd = -1;
    }
  }

  bool connect_client(const char* h, uint16_t p) {
    host = h;
    port = p;
    is_server = false;
    start_threads();
    return true;
  }

  bool serve(uint16_t p) {
    is_server = true;
    port = p;
    listen_fd = ::socket(AF_INET, SOCK_STREAM, 0);
    int one = 1;
    setsockopt(listen_fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
    sockaddr_in addr{};
    addr.sin_family = AF_INET;
    addr.sin_addr.s_addr = htonl(INADDR_LOOPBACK);
    addr.sin_port = htons(p);
    if (bind(listen_fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) != 0)
      return false;
    if (listen(listen_fd, 1) != 0) return false;
    // port 0 = ephemeral: recover the kernel-assigned port
    socklen_t alen = sizeof(addr);
    if (getsockname(listen_fd, reinterpret_cast<sockaddr*>(&addr), &alen) == 0)
      port = ntohs(addr.sin_port);
    start_threads();
    return true;
  }

  void ensure_connected() {
    // (re)connect with retry — the reference retries service calls
    // forever (src/NetworkManager.cc:284-294).  conn_mu: only one of the
    // send/recv threads reconnects; the other would otherwise race a
    // second socket and strand one end in the listen backlog.
    std::unique_lock<std::mutex> conn_lk(conn_mu);
    while (running && fd.load() < 0) {
      if (is_server) {
        int c = ::accept(listen_fd, nullptr, nullptr);
        if (c >= 0) {
          int one = 1;
          setsockopt(c, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
          fd = c;
          reconnects.fetch_add(1);
        }
      } else {
        int s = ::socket(AF_INET, SOCK_STREAM, 0);
        sockaddr_in addr{};
        addr.sin_family = AF_INET;
        addr.sin_port = htons(port);
        inet_pton(AF_INET, host.c_str(), &addr.sin_addr);
        if (::connect(s, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) == 0) {
          int one = 1;
          setsockopt(s, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
          fd = s;
          reconnects.fetch_add(1);
        } else {
          ::close(s);
          std::this_thread::sleep_for(std::chrono::milliseconds(50));
        }
      }
    }
  }

  void start_threads() {
    send_thread = std::thread([this] { send_loop(); });
    recv_thread = std::thread([this] { recv_loop(); });
  }

  void send_loop() {
    while (running) {
      Message msg;
      {
        std::unique_lock<std::mutex> lk(out_mu);
        out_cv.wait(lk, [this] { return !running || !outgoing.empty(); });
        if (!running) return;
        msg = outgoing.front();  // keep until delivered (retry semantics)
      }
      ensure_connected();
      if (!running) return;
      int f = fd.load();
      uint32_t hdr[2] = {kMagic, msg.action};
      uint64_t len = msg.payload.size();
      bool ok = f >= 0 && send_all(f, hdr, sizeof(hdr)) &&
                send_all(f, &len, sizeof(len)) &&
                (len == 0 || send_all(f, msg.payload.data(), len));
      if (ok) {
        msgs_sent.fetch_add(1);
        bytes_sent.fetch_add(sizeof(hdr) + sizeof(len) + len);
        std::unique_lock<std::mutex> lk(out_mu);
        outgoing.pop_front();
      } else {
        int dead = fd.exchange(-1);
        if (dead >= 0) ::close(dead);
      }
    }
  }

  void recv_loop() {
    while (running) {
      ensure_connected();
      if (!running) return;
      int f = fd.load();
      if (f < 0) continue;
      uint32_t hdr[2];
      uint64_t len;
      if (!recv_all(f, hdr, sizeof(hdr)) || hdr[0] != kMagic ||
          !recv_all(f, &len, sizeof(len))) {
        int dead = fd.exchange(-1);
        if (dead >= 0) ::close(dead);
        continue;
      }
      Message msg;
      msg.action = hdr[1];
      msg.payload.resize(len);
      if (len > 0 && !recv_all(f, msg.payload.data(), len)) {
        int dead = fd.exchange(-1);
        if (dead >= 0) ::close(dead);
        continue;
      }
      msgs_recv.fetch_add(1);
      bytes_recv.fetch_add(sizeof(hdr) + sizeof(len) + len);
      {
        std::unique_lock<std::mutex> lk(in_mu);
        incoming.push_back(std::move(msg));
      }
      in_cv.notify_all();
    }
  }

  void enqueue(uint32_t action, const uint8_t* data, uint64_t len) {
    {
      std::unique_lock<std::mutex> lk(out_mu);
      Message m;
      m.action = action;
      m.payload.assign(data, data + len);
      outgoing.push_back(std::move(m));
    }
    out_cv.notify_all();
  }

  // returns payload length (>=0) and fills *action, or -1 on timeout.
  int64_t poll_incoming(uint32_t* action, uint8_t* buf, uint64_t cap,
                        int timeout_ms) {
    std::unique_lock<std::mutex> lk(in_mu);
    auto ready = [this] { return !running || !incoming.empty(); };
    if (!ready()) {
      if (timeout_ms == 0) return -1;
      if (timeout_ms < 0)
        in_cv.wait(lk, ready);
      else if (!in_cv.wait_for(lk, std::chrono::milliseconds(timeout_ms), ready))
        return -1;
    }
    if (incoming.empty()) return -1;
    Message& m = incoming.front();
    if (m.payload.size() > cap) return -2 - int64_t(m.payload.size());
    *action = m.action;
    std::memcpy(buf, m.payload.data(), m.payload.size());
    int64_t n = m.payload.size();
    incoming.pop_front();
    return n;
  }

  int64_t peek_size() {
    std::unique_lock<std::mutex> lk(in_mu);
    if (incoming.empty()) return -1;
    return incoming.front().payload.size();
  }

  // simulate a network partition: force the live connection down.  Both
  // loops detect the failure and re-enter ensure_connected (the reference
  // handles partitions by infinite retry + service reconnect,
  // src/NetworkManager.cc:284-294); undelivered messages stay queued.
  void break_connection() {
    int f = fd.load();
    if (f >= 0) ::shutdown(f, SHUT_RDWR);
  }
};

}  // namespace

extern "C" {

void* nm_create_server(uint16_t port) {
  auto* nm = new NetManager();
  if (!nm->serve(port)) {
    delete nm;
    return nullptr;
  }
  return nm;
}

void* nm_create_client(const char* host, uint16_t port) {
  auto* nm = new NetManager();
  nm->connect_client(host, port);
  return nm;
}

void nm_destroy(void* h) { delete static_cast<NetManager*>(h); }

void nm_send(void* h, uint32_t action, const uint8_t* data, uint64_t len) {
  static_cast<NetManager*>(h)->enqueue(action, data, len);
}

int64_t nm_poll(void* h, uint32_t* action, uint8_t* buf, uint64_t cap,
                int timeout_ms) {
  return static_cast<NetManager*>(h)->poll_incoming(action, buf, cap,
                                                    timeout_ms);
}

int64_t nm_peek_size(void* h) {
  return static_cast<NetManager*>(h)->peek_size();
}

uint16_t nm_port(void* h) { return static_cast<NetManager*>(h)->port; }

// out[5] = {msgs_sent, msgs_recv, bytes_sent, bytes_recv, reconnects}
void nm_stats(void* h, uint64_t* out) {
  auto* nm = static_cast<NetManager*>(h);
  out[0] = nm->msgs_sent.load();
  out[1] = nm->msgs_recv.load();
  out[2] = nm->bytes_sent.load();
  out[3] = nm->bytes_recv.load();
  out[4] = nm->reconnects.load();
}

void nm_break(void* h) { static_cast<NetManager*>(h)->break_connection(); }
}
