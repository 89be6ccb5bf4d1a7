// coloc_tpu native message transport.
//
// Reference parity: the reference's inter-robot communication backend is ROS
// pub/sub — per-drone pose topics and a map point-cloud topic published by
// ROSUtils (rosUtils.hpp:21-94: "coloc/drone{i}/pose" PoseStamped publishers
// + "coloc/map" PointCloud publisher), and image ingest over image_transport
// topics with message_filters approximate-time sync (InterfaceROS.hpp:7-44).
// ROS itself is absent from the target environment; this module is the
// native runtime equivalent: a broker-routed TCP topic bus with the same
// publish/subscribe semantics (named topics, bounded per-topic subscriber
// queues with drop-oldest live-stream behavior, many-to-many fan-out).
//
// Architecture: one lightweight broker (the rosmaster+routing analog, but
// data flows THROUGH it — simpler than ROS's peer wiring and adequate for
// the small payloads the algorithm exchanges: descriptors, poses,
// covariances, scale factors; SURVEY.md §5 "Distributed communication
// backend"). Nodes hold one TCP connection each; a reader thread demuxes
// inbound messages into per-topic bounded queues.
//
// Wire format (all little-endian):
//   frame := u32 body_len | body
//   body  := u8 kind | u16 topic_len | topic bytes | payload bytes
//   kind: 0 = SUBSCRIBE (payload empty), 1 = PUBLISH, 2 = MESSAGE
//         (broker -> subscriber), 3 = UNSUBSCRIBE
//
// C ABI (ctypes-friendly):
//   void* coloc_broker_start(int port);            // 0 -> ephemeral port
//   int   coloc_broker_port(void* broker);
//   void  coloc_broker_stop(void* broker);
//   void* coloc_node_connect(const char* host, int port);
//   int   coloc_node_publish(void* node, const char* topic,
//                            const void* data, int len);
//   int   coloc_node_subscribe(void* node, const char* topic, int depth);
//   int   coloc_node_unsubscribe(void* node, const char* topic);
//   int   coloc_node_receive(void* node, const char* topic, void* out,
//                            int cap, double timeout_s);  // -> payload len,
//                            // -1 timeout, -2 not subscribed, -3 closed;
//                            // payloads larger than cap are truncated to
//                            // cap bytes but report their full length.
//   void  coloc_node_close(void* node);
//
// Build: make -C coloc_tpu/native libcoloc_transport.so

#include <arpa/inet.h>
#include <netdb.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/socket.h>
#include <unistd.h>

#include <chrono>
#include <cstdint>
#include <cstring>
#include <condition_variable>
#include <deque>
#include <map>
#include <memory>
#include <mutex>
#include <set>
#include <string>
#include <thread>
#include <vector>

namespace {

constexpr uint8_t kSubscribe = 0;
constexpr uint8_t kPublish = 1;
constexpr uint8_t kMessage = 2;
constexpr uint8_t kUnsubscribe = 3;
constexpr uint32_t kMaxBody = 64u << 20;  // 64 MB message ceiling

// Full-buffer send/recv over a blocking socket; false on error/EOF.
bool send_all(int fd, const void* data, size_t len) {
  const char* p = static_cast<const char*>(data);
  while (len > 0) {
    ssize_t n = ::send(fd, p, len, MSG_NOSIGNAL);
    if (n <= 0) return false;
    p += n;
    len -= static_cast<size_t>(n);
  }
  return true;
}

bool recv_all(int fd, void* data, size_t len) {
  char* p = static_cast<char*>(data);
  while (len > 0) {
    ssize_t n = ::recv(fd, p, len, 0);
    if (n <= 0) return false;
    p += n;
    len -= static_cast<size_t>(n);
  }
  return true;
}

// body := kind | topic_len | topic | payload, framed with a u32 length.
std::vector<uint8_t> make_frame(uint8_t kind, const std::string& topic,
                                const void* payload, uint32_t plen) {
  uint32_t body = 1u + 2u + static_cast<uint32_t>(topic.size()) + plen;
  std::vector<uint8_t> buf(4u + body);
  std::memcpy(buf.data(), &body, 4);
  buf[4] = kind;
  uint16_t tlen = static_cast<uint16_t>(topic.size());
  std::memcpy(buf.data() + 5, &tlen, 2);
  std::memcpy(buf.data() + 7, topic.data(), topic.size());
  if (plen) std::memcpy(buf.data() + 7 + topic.size(), payload, plen);
  return buf;
}

// Read one frame; true on success with body filled (kind|tlen|topic|payload).
bool read_frame(int fd, std::vector<uint8_t>& body) {
  uint32_t len = 0;
  if (!recv_all(fd, &len, 4)) return false;
  if (len < 3 || len > kMaxBody) return false;
  body.resize(len);
  return recv_all(fd, body.data(), len);
}

bool parse_body(const std::vector<uint8_t>& body, uint8_t& kind,
                std::string& topic, const uint8_t*& payload, uint32_t& plen) {
  if (body.size() < 3) return false;
  kind = body[0];
  uint16_t tlen = 0;
  std::memcpy(&tlen, body.data() + 1, 2);
  if (body.size() < 3u + tlen) return false;
  topic.assign(reinterpret_cast<const char*>(body.data() + 3), tlen);
  payload = body.data() + 3 + tlen;
  plen = static_cast<uint32_t>(body.size() - 3 - tlen);
  return true;
}

// ---------------------------------------------------------------------------
// Broker
// ---------------------------------------------------------------------------

struct BrokerClient {
  uint64_t id = 0;        // map key: monotonic id, NOT the fd (fd numbers are
                          // reused by the kernel; keying by fd let a new
                          // connection be erased by an old one's teardown)
  int fd = -1;            // -1 once closed; read/written under write_mu only
  std::mutex write_mu;    // serialize frames to this subscriber + fd lifetime
  std::set<std::string> topics;
  std::thread reader;     // joinable — joined by reap()/stop, never detached
};

struct Broker {
  int listen_fd = -1;
  int port = 0;
  std::mutex mu;  // guards clients + dead_ids
  std::map<uint64_t, std::shared_ptr<BrokerClient>> clients;
  std::vector<uint64_t> dead_ids;  // finished readers awaiting join
  uint64_t next_id = 1;
  std::thread acceptor;

  void route(const std::string& topic, const std::vector<uint8_t>& body) {
    // Re-frame as MESSAGE once, fan out to every subscriber of the topic.
    std::vector<uint8_t> frame(4 + body.size());
    uint32_t len = static_cast<uint32_t>(body.size());
    std::memcpy(frame.data(), &len, 4);
    std::memcpy(frame.data() + 4, body.data(), body.size());
    frame[4] = kMessage;

    std::vector<std::shared_ptr<BrokerClient>> targets;
    {
      std::lock_guard<std::mutex> lk(mu);
      for (auto& kv : clients)
        if (kv.second->topics.count(topic)) targets.push_back(kv.second);
    }
    for (auto& c : targets) {
      std::lock_guard<std::mutex> lk(c->write_mu);
      if (c->fd >= 0)  // skip clients torn down after the snapshot
        send_all(c->fd, frame.data(), frame.size());  // drop on error; the
                                                      // reader reaps the client
    }
  }

  void serve_client(std::shared_ptr<BrokerClient> client) {
    std::vector<uint8_t> body;
    while (true) {
      {
        // fd may be shut down by stop(); a closed fd is EOF below
        std::lock_guard<std::mutex> lk(client->write_mu);
        if (client->fd < 0) break;
      }
      if (!read_frame(client->fd, body)) break;
      uint8_t kind;
      std::string topic;
      const uint8_t* payload;
      uint32_t plen;
      if (!parse_body(body, kind, topic, payload, plen)) break;
      if (kind == kSubscribe) {
        std::lock_guard<std::mutex> lk(mu);
        client->topics.insert(topic);
      } else if (kind == kUnsubscribe) {
        std::lock_guard<std::mutex> lk(mu);
        client->topics.erase(topic);
      } else if (kind == kPublish) {
        route(topic, body);
      }
    }
    {
      // Close under write_mu so route() can never write to a closed/reused
      // fd; fd = -1 marks the client dead for route()'s snapshot.
      std::lock_guard<std::mutex> lk(client->write_mu);
      if (client->fd >= 0) {
        ::shutdown(client->fd, SHUT_RDWR);
        ::close(client->fd);
        client->fd = -1;
      }
    }
    std::lock_guard<std::mutex> lk(mu);
    dead_ids.push_back(client->id);  // reaped (joined + erased) by
                                     // accept_loop or stop
  }

  // Join + erase finished clients. Never called from a reader thread.
  void reap() {
    std::vector<std::thread> done;
    {
      std::lock_guard<std::mutex> lk(mu);
      for (uint64_t id : dead_ids) {
        auto it = clients.find(id);
        if (it == clients.end()) continue;
        done.push_back(std::move(it->second->reader));
        clients.erase(it);
      }
      dead_ids.clear();
    }
    for (auto& t : done)
      if (t.joinable()) t.join();
  }

  void accept_loop() {
    while (true) {
      int fd = ::accept(listen_fd, nullptr, nullptr);
      if (fd < 0) return;  // listen_fd closed -> stop
      reap();
      int one = 1;
      ::setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
      auto client = std::make_shared<BrokerClient>();
      client->fd = fd;
      {
        std::lock_guard<std::mutex> lk(mu);
        client->id = next_id++;
        clients[client->id] = client;
      }
      client->reader = std::thread([this, client] { serve_client(client); });
    }
  }
};

// ---------------------------------------------------------------------------
// Node
// ---------------------------------------------------------------------------

struct TopicQueue {
  size_t depth = 16;
  std::deque<std::vector<uint8_t>> items;  // payload bytes
};

struct Node {
  int fd = -1;
  std::mutex write_mu;
  std::mutex mu;  // guards queues + closed
  std::condition_variable cv;
  std::map<std::string, TopicQueue> queues;
  bool closed = false;
  std::thread reader;

  void reader_loop() {
    std::vector<uint8_t> body;
    while (read_frame(fd, body)) {
      uint8_t kind;
      std::string topic;
      const uint8_t* payload;
      uint32_t plen;
      if (!parse_body(body, kind, topic, payload, plen)) break;
      if (kind != kMessage) continue;
      std::lock_guard<std::mutex> lk(mu);
      auto it = queues.find(topic);
      if (it == queues.end()) continue;  // late unsubscribe race: drop
      auto& q = it->second;
      if (q.items.size() >= q.depth) q.items.pop_front();  // drop oldest
      q.items.emplace_back(payload, payload + plen);
      cv.notify_all();
    }
    {
      std::lock_guard<std::mutex> lk(mu);
      closed = true;
    }
    cv.notify_all();
  }
};

}  // namespace

extern "C" {

void* coloc_broker_start(int port) {
  int fd = ::socket(AF_INET, SOCK_STREAM, 0);
  if (fd < 0) return nullptr;
  int one = 1;
  ::setsockopt(fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  // Bind all interfaces so nodes on OTHER machines can join this broker
  // (the rosmaster model; a loopback-only bind made the documented
  // cross-machine `--publish HOST:PORT` join impossible).
  addr.sin_addr.s_addr = htonl(INADDR_ANY);
  addr.sin_port = htons(static_cast<uint16_t>(port));
  if (::bind(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) < 0 ||
      ::listen(fd, 64) < 0) {
    ::close(fd);
    return nullptr;
  }
  socklen_t alen = sizeof(addr);
  ::getsockname(fd, reinterpret_cast<sockaddr*>(&addr), &alen);

  auto* broker = new Broker();
  broker->listen_fd = fd;
  broker->port = ntohs(addr.sin_port);
  broker->acceptor = std::thread([broker] { broker->accept_loop(); });
  return broker;
}

int coloc_broker_port(void* handle) {
  return handle ? static_cast<Broker*>(handle)->port : -1;
}

void coloc_broker_stop(void* handle) {
  if (!handle) return;
  auto* broker = static_cast<Broker*>(handle);
  ::shutdown(broker->listen_fd, SHUT_RDWR);
  ::close(broker->listen_fd);
  if (broker->acceptor.joinable()) broker->acceptor.join();
  // Shut down every live client socket (readers see EOF and tear down),
  // then JOIN every reader thread — the broker may only be freed once no
  // thread can touch it again (the old detached-thread + bounded-wait
  // scheme freed the broker under still-running readers on slow machines).
  std::vector<std::shared_ptr<BrokerClient>> remaining;
  {
    std::lock_guard<std::mutex> lk(broker->mu);
    for (auto& kv : broker->clients) remaining.push_back(kv.second);
  }
  for (auto& c : remaining) {
    std::lock_guard<std::mutex> lk(c->write_mu);
    if (c->fd >= 0) ::shutdown(c->fd, SHUT_RDWR);
  }
  for (auto& c : remaining)
    if (c->reader.joinable()) c->reader.join();
  delete broker;
}

void* coloc_node_connect(const char* host, int port) {
  // Resolve hostnames as well as numeric addresses — a node joining a
  // remote broker (`--publish robot1:9000`) names the host, not an IP.
  addrinfo hints{};
  hints.ai_family = AF_INET;
  hints.ai_socktype = SOCK_STREAM;
  addrinfo* res = nullptr;
  std::string port_s = std::to_string(port);
  if (::getaddrinfo(host, port_s.c_str(), &hints, &res) != 0 || !res)
    return nullptr;
  int fd = ::socket(res->ai_family, res->ai_socktype, res->ai_protocol);
  if (fd < 0) {
    ::freeaddrinfo(res);
    return nullptr;
  }
  int rc = ::connect(fd, res->ai_addr, res->ai_addrlen);
  ::freeaddrinfo(res);
  if (rc < 0) {
    ::close(fd);
    return nullptr;
  }
  int one = 1;
  ::setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
  auto* node = new Node();
  node->fd = fd;
  node->reader = std::thread([node] { node->reader_loop(); });
  return node;
}

int coloc_node_publish(void* handle, const char* topic, const void* data,
                       int len) {
  if (!handle || len < 0) return -1;
  auto* node = static_cast<Node*>(handle);
  auto frame = make_frame(kPublish, topic, data, static_cast<uint32_t>(len));
  std::lock_guard<std::mutex> lk(node->write_mu);
  return send_all(node->fd, frame.data(), frame.size()) ? 0 : -1;
}

int coloc_node_subscribe(void* handle, const char* topic, int depth) {
  if (!handle || depth < 1) return -1;
  auto* node = static_cast<Node*>(handle);
  {
    std::lock_guard<std::mutex> lk(node->mu);
    node->queues[topic].depth = static_cast<size_t>(depth);
  }
  auto frame = make_frame(kSubscribe, topic, nullptr, 0);
  std::lock_guard<std::mutex> lk(node->write_mu);
  return send_all(node->fd, frame.data(), frame.size()) ? 0 : -1;
}

int coloc_node_unsubscribe(void* handle, const char* topic) {
  if (!handle) return -1;
  auto* node = static_cast<Node*>(handle);
  {
    std::lock_guard<std::mutex> lk(node->mu);
    node->queues.erase(topic);
  }
  auto frame = make_frame(kUnsubscribe, topic, nullptr, 0);
  std::lock_guard<std::mutex> lk(node->write_mu);
  return send_all(node->fd, frame.data(), frame.size()) ? 0 : -1;
}

int coloc_node_receive(void* handle, const char* topic, void* out, int cap,
                       double timeout_s) {
  if (!handle) return -3;
  auto* node = static_cast<Node*>(handle);
  std::unique_lock<std::mutex> lk(node->mu);
  auto deadline = std::chrono::steady_clock::now() +
                  std::chrono::duration_cast<std::chrono::nanoseconds>(
                      std::chrono::duration<double>(timeout_s));
  // Re-find the queue after every wait: wait_until releases the mutex, and
  // a concurrent unsubscribe() may erase the entry (a held iterator would
  // dangle into freed map-node memory).
  for (;;) {
    auto it = node->queues.find(topic);
    if (it == node->queues.end()) return -2;
    if (!it->second.items.empty()) break;
    if (node->closed) return -3;
    if (node->cv.wait_until(lk, deadline) == std::cv_status::timeout) {
      auto it2 = node->queues.find(topic);
      if (it2 == node->queues.end()) return -2;
      if (!it2->second.items.empty()) break;
      return node->closed ? -3 : -1;
    }
  }
  auto it = node->queues.find(topic);
  std::vector<uint8_t> payload = std::move(it->second.items.front());
  it->second.items.pop_front();
  lk.unlock();
  int n = static_cast<int>(payload.size());
  if (out && cap > 0)
    std::memcpy(out, payload.data(),
                static_cast<size_t>(n < cap ? n : cap));
  return n;
}

void coloc_node_close(void* handle) {
  if (!handle) return;
  auto* node = static_cast<Node*>(handle);
  ::shutdown(node->fd, SHUT_RDWR);
  if (node->reader.joinable()) node->reader.join();
  ::close(node->fd);
  delete node;
}

}  // extern "C"
